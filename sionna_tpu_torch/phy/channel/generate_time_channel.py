"""Generate discrete-time channels from a ChannelModel (counterpart of
``sionna_tpu/phy/channel/generate_time_channel.py``)."""

from ..block import Block
from .utils import cir_to_time_channel

__all__ = ["GenerateTimeChannel"]


class GenerateTimeChannel(Block):
    """Samples (a, tau) on the block's device and converts them to
    discrete-time channel taps.

    Output: [batch, num_rx, num_rx_ant, num_tx, num_tx_ant,
    num_time_samples + l_tot - 1, l_tot].
    """

    def __init__(self, channel_model, bandwidth, num_time_samples,
                 l_min, l_max, normalize_channel=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._cir_sampler = channel_model
        self._bandwidth = float(bandwidth)
        self._num_time_steps = int(num_time_samples)
        self._l_min = int(l_min)
        self._l_max = int(l_max)
        self._l_tot = self._l_max - self._l_min + 1
        self._normalize = bool(normalize_channel)

    def numpy_structure(self):
        """The channel model's tables, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        if not hasattr(self._cir_sampler, "numpy_structure"):
            return {}
        return {f"channel_model.{k}": v for k, v in
                self._cir_sampler.numpy_structure().items()}

    def forward(self, batch_size, generator=None):
        a, tau = self._cir_sampler(
            int(batch_size), self._num_time_steps + self._l_tot - 1,
            self._bandwidth, generator=generator, device=self.device)
        return cir_to_time_channel(self._bandwidth, a, tau, self._l_min,
                                   self._l_max, normalize=self._normalize)
