"""Time-domain channel: generate + apply (counterpart of
``sionna_tpu/phy/channel/time_channel.py``)."""

from ..block import Block
from .apply_time_channel import ApplyTimeChannel
from .generate_time_channel import GenerateTimeChannel
from .utils import time_lag_discrete_time_channel

__all__ = ["TimeChannel"]


class TimeChannel(Block):
    """Samples the channel, applies the doubly-selective time-domain
    convolution, and optionally adds noise / returns the channel.

    Both the channel and the noise are drawn from ``generator`` when
    given, else from ``config.generator`` of the block's device.
    """

    def __init__(self, channel_model, bandwidth, num_time_samples,
                 maximum_delay_spread=3e-6, l_min=None, l_max=None,
                 normalize_channel=False, add_awgn=True,
                 return_channel=False, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        l_min_def, l_max_def = time_lag_discrete_time_channel(
            bandwidth, maximum_delay_spread)
        l_min = l_min_def if l_min is None else int(l_min)
        l_max = l_max_def if l_max is None else int(l_max)
        self._l_min, self._l_max = l_min, l_max
        self._l_tot = l_max - l_min + 1
        self._gen = GenerateTimeChannel(channel_model, bandwidth,
                                        num_time_samples, l_min, l_max,
                                        normalize_channel=normalize_channel,
                                        precision=precision, device=device)
        self._app = ApplyTimeChannel(num_time_samples, self._l_tot,
                                     precision=precision, device=device)
        self._add_awgn = bool(add_awgn)
        self._return_channel = bool(return_channel)

    @property
    def l_min(self):
        return self._l_min

    @property
    def l_max(self):
        return self._l_max

    def forward(self, x, no=None, generator=None):
        h_time = self._gen(x.shape[0], generator=generator)
        y = self._app(x, h_time, no if self._add_awgn else None,
                      generator=generator)
        if self._return_channel:
            return y, h_time
        return y
