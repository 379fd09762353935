"""Upsampling (counterpart of ``sionna_tpu/phy/signal/upsampling.py``)."""

from ..block import Block


class Upsampling(Block):
    """Inserts ``samples_per_symbol - 1`` zeros after every sample along
    ``axis``: the output is ``samples_per_symbol`` times as long."""

    def __init__(self, samples_per_symbol, axis=-1, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._samples_per_symbol = int(samples_per_symbol)
        self._axis = axis

    def forward(self, x):
        x = x.movedim(self._axis, -1)
        up = x.new_zeros(x.shape[:-1]
                         + (x.shape[-1] * self._samples_per_symbol,))
        up[..., ::self._samples_per_symbol] = x
        return up.movedim(-1, self._axis)
