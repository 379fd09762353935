"""OFDM channel: generate + apply (counterpart of
``sionna_tpu/phy/channel/ofdm_channel.py``)."""

from ..block import Block
from .generate_ofdm_channel import GenerateOFDMChannel
from .apply_ofdm_channel import ApplyOFDMChannel


class OFDMChannel(Block):
    """Samples the channel, applies it in the frequency domain, and
    optionally adds noise / returns the channel.

    Both the channel and the noise are drawn from ``generator`` when
    given, else from ``config.generator`` of the block's device.
    """

    def __init__(self, channel_model, resource_grid, add_awgn=True,
                 normalize_channel=False, return_channel=False,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.gen = GenerateOFDMChannel(channel_model, resource_grid,
                                       normalize_channel=normalize_channel,
                                       precision=precision, device=device)
        self.app = ApplyOFDMChannel(precision=precision, device=device)
        self._add_awgn = bool(add_awgn)
        self._return_channel = bool(return_channel)

    def forward(self, x, no=None, generator=None):
        h_freq = self.gen(x.shape[0], generator=generator)
        y = self.app(x, h_freq, no if self._add_awgn else None,
                     generator=generator)
        if self._return_channel:
            return y, h_freq
        return y
