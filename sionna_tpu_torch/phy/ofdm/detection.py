"""OFDM detection base (counterpart of ``sionna_tpu/phy/ofdm/detection.py``;
the port has the ``OFDMDetector`` base that the equalizers build on).

Data-RE extraction is one gather with indices computed on the host; the
JAX package's one-hot and plane extractions are TPU layout work and are
left out.
"""

import numpy as np
import torch

from ..block import Block
from ..utils.linalg import _adjoint, _matmul
from ..utils.tensors import expand_to_rank
from .resource_grid import RemoveNulledSubcarriers

__all__ = ["OFDMDetector"]


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
