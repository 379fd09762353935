"""OFDM MIMO equalization (counterpart of
``sionna_tpu/phy/ofdm/equalization.py``): the LMMSE, ZF and MF
equalizers on the generic per-RE algebra (not the JAX package's plane
path, which is TPU layout work), and the post-equalization SINR."""

import torch

from ..block import Block
from ..mimo import lmmse_equalizer, lmmse_matrix, mf_equalizer, zf_equalizer
from ..utils.linalg import _adjoint, _matmul, inv_cholesky
from ..utils.tensors import expand_to_rank
from .detection import OFDMDetector

__all__ = ["OFDMEqualizer", "LMMSEEqualizer", "ZFEqualizer", "MFEqualizer",
           "PostEqualizationSINR", "LMMSEPostEqualizationSINR"]


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


class ZFEqualizer(OFDMEqualizer):
    """ZF OFDM equalizer."""

    def __init__(self, resource_grid, stream_management, precision=None,
                 device=None):
        super().__init__(zf_equalizer, resource_grid, stream_management,
                         precision=precision, device=device)


class MFEqualizer(OFDMEqualizer):
    """MF OFDM equalizer."""

    def __init__(self, resource_grid, stream_management, precision=None,
                 device=None):
        super().__init__(mf_equalizer, resource_grid, stream_management,
                         precision=precision, device=device)


class PostEqualizationSINR(Block):
    """Abstract block computing the per-stream SINR after equalization
    from an effective (precoded) channel.

    Input: h_eff [b, rx, rxa, tx, streams_per_tx, sym, n_eff_sc], no
    (broadcastable), optional h_eff_hat. Output: sinr [b, sym,
    n_eff_sc, rx, streams_per_rx].
    """

    def __init__(self, resource_grid, stream_management, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._resource_grid = resource_grid
        self._stream_management = stream_management

    def get_per_rx_channels(self, h_eff):
        """Splits the effective channel into desired and undesired
        streams per receiver: (h_eff_desired [b, rx, sym, sc, rxa,
        streams_per_rx], h_eff_undesired [b, rx, sym, sc, rxa,
        n_interf])."""
        sm = self._stream_management
        # [rx * tx * streams_per_tx, b, rxa, sym, sc]
        h = h_eff.permute(1, 3, 4, 0, 2, 5, 6)
        h = h.reshape((-1,) + tuple(h.shape[3:]))
        dev = h.device
        h_des = h[torch.as_tensor(sm.detection_desired_ind, device=dev)]
        h_und = h[torch.as_tensor(sm.detection_undesired_ind, device=dev)]
        h_des = h_des.reshape((sm.num_rx, sm.num_streams_per_rx)
                              + tuple(h_des.shape[1:]))
        h_und = h_und.reshape((sm.num_rx, -1) + tuple(h_und.shape[1:]))
        # [b, rx, sym, sc, rxa, streams]
        return (h_des.permute(2, 0, 4, 5, 3, 1),
                h_und.permute(2, 0, 4, 5, 3, 1))

    def compute_interference_covariance_matrix(self, no=None,
                                               h_eff_undesired=None):
        """S = diag(no) + H_u H_u^H."""
        s = 0.
        if no is not None:
            s = s + torch.diag_embed(
                torch.as_tensor(no).to(self.rdtype)).to(self.cdtype)
        if h_eff_undesired is not None:
            s = s + _matmul(h_eff_undesired, _adjoint(h_eff_undesired))
        return s

    def compute_desired_signal_power(self, h_eff_desired, f):
        """|f_s^H h_s|^2 per stream."""
        p = torch.einsum("...mn,...nm->...m", f, h_eff_desired)
        return torch.abs(p) ** 2

    def compute_total_power(self, h_eff_desired, h_eff_undesired, f):
        """sum_s' |f^H h_s'|^2."""
        h_all = torch.cat([h_eff_desired, h_eff_undesired], dim=-1)
        return torch.sum(torch.abs(_matmul(f, h_all)) ** 2, dim=-1)

    def compute_noise_power(self, no, f):
        """sigma^2 ||f||^2."""
        no = torch.as_tensor(no).to(self.rdtype)[..., None, :]
        return torch.sum(torch.abs(f) ** 2 * no, dim=-1)

    def compute_sinr(self, h_eff_desired, h_eff_undesired, no, f):
        """SINR_s = u_s / (v_s + n_s), [b, sym, sc, rx,
        streams_per_rx]."""
        signal_power = self.compute_desired_signal_power(h_eff_desired, f)
        total_power = self.compute_total_power(h_eff_desired,
                                               h_eff_undesired, f)
        interference = torch.clamp_min(total_power - signal_power, 0.)
        noise_power = self.compute_noise_power(no, f)
        den = interference + noise_power
        sinr = torch.where(den > 0., signal_power / den,
                           torch.zeros_like(den))
        return sinr.permute(0, 2, 3, 1, 4)

    def forward(self, h_eff, no, h_eff_hat=None):
        raise NotImplementedError


class LMMSEPostEqualizationSINR(PostEqualizationSINR):
    """SINR after LMMSE equalization, with optional interference
    whitening."""

    def forward(self, h_eff, no, h_eff_hat=None,
                interference_whitening=True):
        if h_eff_hat is None:
            h_eff_hat = h_eff
        h_eff = torch.as_tensor(h_eff).to(self.cdtype)
        h_eff_hat = torch.as_tensor(h_eff_hat).to(self.cdtype)
        no = expand_to_rank(torch.as_tensor(no).to(device=h_eff.device,
                                                   dtype=self.rdtype),
                            5, axis=-1)
        no = no.expand(h_eff.shape[0], h_eff.shape[1], h_eff.shape[2],
                       h_eff.shape[5], h_eff.shape[6])
        no = no.permute(0, 1, 3, 4, 2)  # [b, rx, sym, sc, rxa]

        h_des, h_und = self.get_per_rx_channels(h_eff_hat)
        s = self.compute_interference_covariance_matrix(
            no=no, h_eff_undesired=h_und if interference_whitening
            else None)
        l_inv = inv_cholesky(s)
        h_des = _matmul(l_inv, h_des)
        h_und = _matmul(l_inv, h_und)
        f = lmmse_matrix(h_des, precision=self.precision)
        return self.compute_sinr(h_des, h_und, torch.ones_like(no), f)
