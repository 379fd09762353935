"""OFDM MIMO equalization (counterpart of
``sionna_tpu/phy/ofdm/equalization.py``; the port has the LMMSE
equalizer on the generic per-RE algebra, not the JAX package's plane
path, which is TPU layout work)."""

from ..mimo import lmmse_equalizer
from .detection import OFDMDetector

__all__ = ["OFDMEqualizer", "LMMSEEqualizer"]


class OFDMEqualizer(OFDMDetector):
    """Wraps a per-RE MIMO equalizer function for OFDM resource grids.

    ``equalizer(y, h, s, precision=...)`` returns (x_hat, no_eff).
    Output: (x_hat [b, num_tx, num_streams, num_data_symbols], no_eff
    same shape).
    """

    def __init__(self, equalizer, resource_grid, stream_management,
                 precision=None, device=None):
        if not callable(equalizer):
            raise TypeError("equalizer must be callable.")
        super().__init__(equalizer, "symbol", resource_grid,
                         stream_management, precision=precision,
                         device=device)

    def forward(self, y, h_hat, err_var, no):
        y_dt, h_desired, s = self._preprocess_inputs(y, h_hat, err_var,
                                                     no)
        x_hat, no_eff = self._detector(y_dt, h_desired, s,
                                       precision=self.precision)
        return (self._extract_datasymbols(x_hat),
                self._extract_datasymbols(no_eff))


class LMMSEEqualizer(OFDMEqualizer):
    """LMMSE OFDM equalizer."""

    def __init__(self, resource_grid, stream_management,
                 whiten_interference=True, precision=None, device=None):
        def eq(y, h, s, precision=None):
            return lmmse_equalizer(y, h, s,
                                   whiten_interference=whiten_interference,
                                   precision=precision)
        super().__init__(eq, resource_grid, stream_management,
                         precision=precision, device=device)
        self._whiten_interference = whiten_interference
