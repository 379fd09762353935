"""OFDM detection (counterpart of ``sionna_tpu/phy/ofdm/detection.py``):
the ``OFDMDetector`` base that the equalizers build on, its variant with
priors, and the grid wrappers of the MIMO detectors. None of these
blocks has trainable parameters.

Data-RE extraction is one gather with indices computed on the host; the
JAX package's one-hot and plane extractions are TPU layout work and are
left out.
"""

import numpy as np
import torch

from ..block import Block
from ..mapping import Constellation
from ..mimo import detection as mimo_detection
from ..utils.linalg import _adjoint, _matmul
from ..utils.tensors import expand_to_rank
from .resource_grid import RemoveNulledSubcarriers

__all__ = ["OFDMDetector", "OFDMDetectorWithPrior", "LinearDetector",
           "MaximumLikelihoodDetector", "MaximumLikelihoodDetectorWithPrior",
           "KBestDetector", "EPDetector", "MMSEPICDetector"]


class OFDMDetector(Block):
    """Wraps a per-RE MIMO detector for OFDM resource grids.

    ``detector(y, h, s)`` takes y [..., num_rx_ant], h [..., num_rx_ant,
    num_streams_per_rx] and s [..., num_rx_ant, num_rx_ant] and returns
    per-stream values [..., num_streams_per_rx(, d)]. Calling the block
    with (y, h_hat, err_var, no) returns them for the data REs,
    [b, num_tx, num_streams_per_tx, num_data_symbols(, d)].
    """

    def __init__(self, detector, output, resource_grid,
                 stream_management, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._detector = detector
        self._resource_grid = resource_grid
        self._stream_management = stream_management
        self._removed_nulled_scs = RemoveNulledSubcarriers(
            resource_grid, precision=self.precision, device=device)
        self._output = output
        mask = np.array(resource_grid.pilot_pattern.mask)
        num_data_symbols = resource_grid.pilot_pattern.num_data_symbols
        mask_flat = mask.reshape(mask.shape[:-2] + (-1,))
        # stable sort: data positions (mask==0) first, in row-major order
        data_ind = np.argsort(mask_flat, axis=-1, kind="stable")
        sm = stream_management

        def buf(name, values):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(values, np.int64), device=self.device),
                persistent=False)

        buf("_data_ind", data_ind[..., :num_data_symbols])
        buf("_desired_ind", sm.detection_desired_ind)
        buf("_undesired_ind", sm.detection_undesired_ind)
        buf("_stream_ind", sm.stream_ind)

    def _preprocess_inputs(self, y, h_hat, err_var, no):
        """Returns y [b, rx, sym, eff, rxa], the desired channels
        [b, rx, sym, eff, rxa, s_rx] and the noise-plus-interference
        covariance [b, rx, sym, eff, rxa, rxa]."""
        sm = self._stream_management
        y = torch.as_tensor(y).to(self.cdtype)
        h_hat = torch.as_tensor(h_hat).to(self.cdtype)
        err_var = torch.as_tensor(err_var).to(device=y.device,
                                              dtype=self.rdtype)
        no = torch.as_tensor(no).to(device=y.device, dtype=self.rdtype)

        y_eff = self._removed_nulled_scs(y)
        y_dt = y_eff.permute(0, 1, 3, 4, 2)

        # error variances: [b, rx, sym, eff, rxa, tx*s]
        err_var_dt = err_var.expand(h_hat.shape).permute(0, 1, 5, 6, 2, 3, 4)
        err_var_dt = err_var_dt.reshape(err_var_dt.shape[:-2] + (-1,))

        # desired/undesired channels -> [b, rx, sym, eff, rxa, streams]
        h_dt = h_hat.permute(1, 3, 4, 0, 2, 5, 6)
        h_dt = h_dt.reshape((-1,) + h_dt.shape[3:])  # [rx*tx*s, b, ...]

        def select(ind, n_per_rx):
            h = h_dt[ind.to(y.device)]
            h = h.reshape((sm.num_rx, n_per_rx) + h.shape[1:])
            return h.permute(2, 0, 4, 5, 3, 1)

        h_desired = select(self._desired_ind, sm.num_streams_per_rx)
        h_undesired = select(self._undesired_ind,
                             len(sm.detection_undesired_ind) // sm.num_rx)

        # noise-plus-interference covariance
        no3 = expand_to_rank(no, 3, -1).expand(y.shape[:3])
        no_dt = no3[:, :, None, None, :].expand(y_dt.shape)
        eye = torch.eye(y_dt.shape[-1], dtype=self.cdtype, device=y.device)
        s = (_matmul(h_undesired, _adjoint(h_undesired))
             + (no_dt[..., None] * eye).to(self.cdtype)
             + (torch.sum(err_var_dt, -1)[..., None] * eye).to(self.cdtype))
        return y_dt, h_desired, s

    def _extract_datasymbols(self, z):
        """z: [b, rx, sym, eff, s_rx(, d)] -> [b, tx, s_tx,
        n_data(, d)] (flattened over d for "bit" output)."""
        sm = self._stream_management
        rank_extended = z.dim() < 6
        z = expand_to_rank(z, 6, -1)
        b, d = z.shape[0], z.shape[-1]
        # -> [b, rx * s_rx, sym * eff, d], streams in tx order
        z = z.permute(0, 1, 4, 2, 3, 5)
        z = z.reshape(b, -1, z.shape[3] * z.shape[4], d)
        z = z[:, self._stream_ind.to(z.device)]
        z = z.reshape((b, sm.num_tx, sm.num_streams_per_tx) + z.shape[2:])
        idx = self._data_ind.to(z.device)[None, ..., None]
        z = torch.gather(z, 3, idx.expand((b,) + idx.shape[1:4] + (d,)))
        if self._output == "bit":
            return z.reshape(z.shape[:3] + (-1,))
        if rank_extended:
            z = z[..., 0]
        return z

    def forward(self, y, h_hat, err_var, no):
        y_dt, h_desired, s = self._preprocess_inputs(y, h_hat, err_var,
                                                     no)
        return self._extract_datasymbols(self._detector(y_dt, h_desired, s))


class OFDMDetectorWithPrior(OFDMDetector):
    """OFDM detector wrapper that passes priors to the MIMO detector:
    called with ``(y, h_hat, prior, err_var, no)``.

    A prior is given per data RE, ``[b, num_tx, s_tx,
    num_data_symbols * nbps]`` ("bit") or ``[b, num_tx, s_tx,
    num_data_symbols, num_points]`` ("symbol"), or per stream,
    ``[b, num_tx, s_tx, nbps]`` / ``[b, num_tx, s_tx, num_points]``,
    then broadcast over the data REs; ``None`` gives none. Per-RE priors
    go back onto the grid through the inverse of the data-RE gather
    (pilot REs get a zero prior, uninformative for LLRs and logits).
    """

    def __init__(self, detector, output, resource_grid,
                 stream_management, constellation, precision=None,
                 device=None):
        super().__init__(detector, output, resource_grid,
                         stream_management, precision=precision,
                         device=device)
        self._constellation = constellation
        # for each (tx, stream) and grid position sym * eff: its index
        # in the data-symbol list, or n_data (a zero row) if not data
        data_ind = self._data_ind.cpu().numpy()
        n_data = data_ind.shape[-1]
        mask = np.array(resource_grid.pilot_pattern.mask)
        inv = np.full(data_ind.shape[:-1] + (mask.shape[-1] * mask.shape[-2],),
                      n_data, np.int64)
        np.put_along_axis(inv, data_ind, np.arange(n_data), axis=-1)
        self.register_buffer("_inv_data_ind",
                             torch.as_tensor(inv, device=self.device),
                             persistent=False)
        self.register_buffer("_rx_stream_ids", torch.as_tensor(
            np.asarray(stream_management.rx_stream_ids).reshape(-1),
            dtype=torch.int64, device=self.device), persistent=False)

    def _priors_to_grid(self, prior, y_dt_shape):
        """The priors in the detector's layout [b, rx, sym, eff, s_rx,
        d]."""
        sm = self._stream_management
        prior = torch.as_tensor(prior).to(self.rdtype)
        dev = prior.device
        n_data = self._data_ind.shape[-1]
        if self._output == "bit":
            d = self._constellation.num_bits_per_symbol
            per_re = prior.shape[-1] != d or n_data * d == d
        else:
            d = prior.shape[-1]
            per_re = prior.dim() >= 5
        b = prior.shape[0]
        rx_ids = self._rx_stream_ids.to(dev)
        if per_re:
            pr = prior.reshape(b, sm.num_tx, sm.num_streams_per_tx, n_data, d)
            pr = torch.cat([pr, torch.zeros(pr.shape[:3] + (1, d),
                                            dtype=pr.dtype, device=dev)],
                           dim=3)
            inv = self._inv_data_ind.to(dev)  # [tx, s, grid]
            idx = inv[None, :, :, :, None].expand((b,) + inv.shape + (d,))
            pr = torch.gather(pr, 3, idx)
            # [b, tx * s, grid, d] in the receivers' stream order
            pr = pr.reshape((b, -1) + pr.shape[3:])[:, rx_ids]
            pr = pr.reshape(b, sm.num_rx, sm.num_streams_per_rx,
                            self._resource_grid.num_ofdm_symbols, -1, d)
            return pr.permute(0, 1, 3, 4, 2, 5)
        pr = prior.reshape(b, -1, d)[:, rx_ids]
        pr = pr.reshape(b, sm.num_rx, sm.num_streams_per_rx, d)
        pr = pr[:, :, None, None]  # broadcast over sym, eff
        return pr.expand(tuple(y_dt_shape[:4]) + pr.shape[-2:])

    def forward(self, y, h_hat, prior, err_var, no):
        y_dt, h_desired, s = self._preprocess_inputs(y, h_hat, err_var, no)
        if prior is None:
            z = self._detector(y_dt, h_desired, s)
        else:
            z = self._detector(y_dt, h_desired, s,
                               prior=self._priors_to_grid(prior, y_dt.shape))
        return self._extract_datasymbols(z)


class LinearDetector(OFDMDetector):
    """OFDM linear detector: an equalizer ("lmmse", "zf", "mf" or a
    callable) and a demapper per stream."""

    def __init__(self, equalizer, output, demapping_method,
                 resource_grid, stream_management,
                 constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        detector = mimo_detection.LinearDetector(
            equalizer, output, demapping_method,
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, hard_out=hard_out,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, precision=precision,
                         device=device)


class MaximumLikelihoodDetector(OFDMDetector):
    """OFDM maximum-likelihood detector."""

    def __init__(self, output, demapping_method, resource_grid,
                 stream_management, constellation_type=None,
                 num_bits_per_symbol=None, constellation=None,
                 hard_out=False, precision=None, device=None):
        detector = mimo_detection.MaximumLikelihoodDetector(
            output, demapping_method, stream_management.num_streams_per_rx,
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, hard_out=hard_out,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, precision=precision,
                         device=device)


class MaximumLikelihoodDetectorWithPrior(OFDMDetectorWithPrior):
    """OFDM maximum-likelihood detector with priors."""

    def __init__(self, output, demapping_method, resource_grid,
                 stream_management, constellation_type=None,
                 num_bits_per_symbol=None, constellation=None,
                 hard_out=False, precision=None, device=None):
        constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        detector = mimo_detection.MaximumLikelihoodDetector(
            output, demapping_method, stream_management.num_streams_per_rx,
            constellation=constellation, hard_out=hard_out,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, constellation,
                         precision=precision, device=device)


class KBestDetector(OFDMDetector):
    """OFDM K-best detector."""

    def __init__(self, output, num_streams, k, resource_grid,
                 stream_management, constellation_type=None,
                 num_bits_per_symbol=None, constellation=None,
                 hard_out=False, use_real_rep=False, list2llr=None,
                 precision=None, device=None):
        detector = mimo_detection.KBestDetector(
            output, num_streams, k, constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, hard_out=hard_out,
            use_real_rep=use_real_rep, list2llr=list2llr,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, precision=precision,
                         device=device)


class EPDetector(OFDMDetector):
    """OFDM expectation-propagation detector."""

    def __init__(self, output, resource_grid, stream_management,
                 num_bits_per_symbol, hard_out=False, l=10, beta=0.9,
                 precision=None, device=None):
        detector = mimo_detection.EPDetector(
            output, num_bits_per_symbol, hard_out=hard_out, l=l, beta=beta,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, precision=precision,
                         device=device)


class MMSEPICDetector(OFDMDetectorWithPrior):
    """OFDM MMSE-PIC detector, soft in and soft out: called with
    ``(y, h_hat, prior, err_var, no)``, ``prior`` the decoder's feedback
    (see :class:`OFDMDetectorWithPrior`) or ``None`` on the first
    pass."""

    def __init__(self, output, resource_grid, stream_management,
                 demapping_method="maxlog", num_iter=1,
                 constellation_type=None, num_bits_per_symbol=None,
                 constellation=None, hard_out=False, precision=None,
                 device=None):
        constellation = Constellation.check_or_create(
            constellation_type=constellation_type,
            num_bits_per_symbol=num_bits_per_symbol,
            constellation=constellation, precision=precision, device=device)
        detector = mimo_detection.MMSEPICDetector(
            output, demapping_method=demapping_method, num_iter=num_iter,
            constellation=constellation, hard_out=hard_out,
            precision=precision, device=device)
        super().__init__(detector, output, resource_grid,
                         stream_management, constellation,
                         precision=precision, device=device)
