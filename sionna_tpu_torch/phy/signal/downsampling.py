"""Downsampling (counterpart of ``sionna_tpu/phy/signal/downsampling.py``)."""

from ..block import Block


class Downsampling(Block):
    """Keeps every ``samples_per_symbol``-th sample along ``axis``,
    starting at ``offset``: ``num_symbols`` outputs (or as many as
    fit)."""

    def __init__(self, samples_per_symbol, offset=0, num_symbols=None,
                 axis=-1, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._samples_per_symbol = int(samples_per_symbol)
        self._offset = int(offset)
        self._num_symbols = num_symbols
        self._axis = axis

    def forward(self, x):
        out = x.movedim(self._axis, -1)[
            ..., self._offset::self._samples_per_symbol]
        if self._num_symbols is not None:
            out = out[..., :self._num_symbols]
        return out.movedim(-1, self._axis)
