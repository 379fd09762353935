"""Generate frequency-domain channels from a ChannelModel (counterpart of
``sionna_tpu/phy/channel/generate_ofdm_channel.py``)."""

from ..block import Block
from .utils import subcarrier_frequencies, cir_to_ofdm_channel


class GenerateOFDMChannel(Block):
    """Samples (a, tau) from a channel model on the block's device and
    converts them to frequency responses over a resource grid.

    Output: [batch, num_rx, num_rx_ant, num_tx, num_tx_ant,
    num_ofdm_symbols, fft_size].
    """

    def __init__(self, channel_model, resource_grid, normalize_channel=False,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._cir_sampler = channel_model
        self._rg = resource_grid
        self._normalize = bool(normalize_channel)
        self.register_buffer("_frequencies", subcarrier_frequencies(
            resource_grid.fft_size, resource_grid.subcarrier_spacing,
            precision=self.precision, device=self.device), persistent=False)
        self._sampling_frequency = 1. / resource_grid.ofdm_symbol_duration

    def numpy_structure(self):
        """The channel model's tables, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        if not hasattr(self._cir_sampler, "numpy_structure"):
            return {}
        return {f"channel_model.{k}": v for k, v in
                self._cir_sampler.numpy_structure().items()}

    def forward(self, batch_size, generator=None):
        a, tau = self._cir_sampler(int(batch_size),
                                   self._rg.num_ofdm_symbols,
                                   self._sampling_frequency,
                                   generator=generator, device=self.device)
        return cir_to_ofdm_channel(self._frequencies, a, tau,
                                   normalize=self._normalize)
