"""Flat-fading channel blocks (counterpart of
``sionna_tpu/phy/channel/flat_fading_channel.py``)."""

import torch

from ..block import Block
from ..config import config
from .awgn import AWGN

__all__ = ["GenerateFlatFadingChannel", "ApplyFlatFadingChannel",
           "FlatFadingChannel"]


class GenerateFlatFadingChannel(Block):
    """Draws i.i.d. flat-fading channel matrices [batch, num_rx_ant,
    num_tx_ant] (each part of variance 1/2) on the block's device, then
    applies ``spatial_corr`` when given.

    The draw comes from ``generator`` when given, else from
    ``config.generator`` of the block's device.
    """

    def __init__(self, num_tx_ant, num_rx_ant, spatial_corr=None,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._num_tx_ant = int(num_tx_ant)
        self._num_rx_ant = int(num_rx_ant)
        self.spatial_corr = spatial_corr

    @property
    def spatial_corr(self):
        return self._spatial_corr

    @spatial_corr.setter
    def spatial_corr(self, value):
        self._spatial_corr = value

    def forward(self, batch_size, generator=None):
        dev = self.device
        if generator is None:
            generator = config.generator(dev)
        shape = (int(batch_size), self._num_rx_ant, self._num_tx_ant)
        std = 0.5 ** 0.5
        hr = torch.randn(shape, generator=generator, dtype=self.rdtype,
                         device=dev)
        hi = torch.randn(shape, generator=generator, dtype=self.rdtype,
                         device=dev)
        h = torch.complex(std * hr, std * hi)
        if self._spatial_corr is not None:
            h = self._spatial_corr(h)
        return h


class ApplyFlatFadingChannel(Block):
    """y = h x, plus AWGN of variance ``no`` when ``no`` is given."""

    def __init__(self, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._awgn = AWGN(precision=self.precision, device=device)

    def forward(self, x, h, no=None, generator=None):
        x = x.to(self.cdtype)
        h = h.to(self.cdtype)
        y = torch.matmul(h, x[..., None])[..., 0]
        if no is not None:
            y = self._awgn(y, no, generator=generator)
        return y


class FlatFadingChannel(Block):
    """Draws a flat-fading channel per batch element, applies it, adds
    AWGN (``add_awgn``) and returns the channel too
    (``return_channel``). Channel and noise come from ``generator`` when
    given, else from ``config.generator`` of the block's device."""

    def __init__(self, num_tx_ant, num_rx_ant, spatial_corr=None,
                 add_awgn=True, return_channel=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._gen = GenerateFlatFadingChannel(
            num_tx_ant, num_rx_ant, spatial_corr=spatial_corr,
            precision=precision, device=device)
        self._app = ApplyFlatFadingChannel(precision=precision,
                                           device=device)
        self._add_awgn = bool(add_awgn)
        self._return_channel = bool(return_channel)

    @property
    def spatial_corr(self):
        return self._gen.spatial_corr

    @spatial_corr.setter
    def spatial_corr(self, value):
        self._gen.spatial_corr = value

    @property
    def generate(self):
        return self._gen

    @property
    def apply(self):
        return self._app

    def forward(self, x, no=None, generator=None):
        h = self._gen(x.shape[0], generator=generator)
        y = self._app(x, h, no if self._add_awgn else None,
                      generator=generator)
        if self._return_channel:
            return y, h
        return y
