"""MIMO precoding functions (counterpart of
``sionna_tpu/phy/mimo/precoding.py``).

The regularized Gram matrices are factored by the port's Cholesky
(unrolled for at most 4 users, ``utils.linalg``)."""

import numpy as np
import torch

from ..config import config, dtypes
from ..constants import PI
from ..utils.linalg import _adjoint, _matmul, batched_cholesky, \
    cholesky_solve
from ..utils.tensors import expand_to_rank

__all__ = ["rzf_precoding_matrix", "cbf_precoding_matrix",
           "rzf_precoder", "grid_of_beams_dft_ula", "grid_of_beams_dft",
           "flatten_precoding_mat", "normalize_precoding_power"]


def _cdtype(precision):
    return config.cdtype if precision is None \
        else dtypes[precision]["torch"]["cdtype"]


def _unit_columns(g):
    """g with each column scaled to unit norm (zero columns stay 0)."""
    norm = torch.sqrt(torch.sum(torch.abs(g) ** 2, dim=-2, keepdim=True))
    return torch.where(norm == 0, torch.zeros_like(g),
                       g / norm.to(g.dtype))


def rzf_precoding_matrix(h, alpha=0., precision=None):
    """Regularized zero-forcing precoder
    G = H^H (H H^H + alpha I)^{-1}, columns normalized to unit power.
    h: [..., K, M] (K users, M tx antennas) -> g: [..., M, K]."""
    cdtype = _cdtype(precision)
    h = torch.as_tensor(h).to(cdtype)
    alpha = torch.as_tensor(alpha, device=h.device).to(cdtype)
    g = _matmul(h, _adjoint(h))
    alpha = expand_to_rank(alpha, g.dim(), axis=-1)
    g = g + alpha * torch.eye(g.shape[-1], dtype=cdtype, device=h.device)
    g = cholesky_solve(batched_cholesky(g), h)
    return _unit_columns(_adjoint(g))


def cbf_precoding_matrix(h, precision=None):
    """Conjugate (matched-filter) beamforming precoder G = H^H with
    unit-power columns."""
    h = torch.as_tensor(h).to(_cdtype(precision))
    return _unit_columns(_adjoint(h))


def rzf_precoder(x, h, alpha=0., return_precoding_matrices=False,
                 precision=None):
    """Applies RZF precoding to symbol vectors x [..., K]."""
    cdtype = _cdtype(precision)
    x = torch.as_tensor(x).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    g = rzf_precoding_matrix(h, alpha=alpha, precision=precision)
    x_precoded = _matmul(g, x[..., None])[..., 0]
    if return_precoding_matrices:
        return x_precoded, g
    return x_precoded


def grid_of_beams_dft_ula(num_ant, oversmpl=1, precision=None,
                          device=None):
    """DFT grid-of-beams vectors of a ULA: [num_ant * oversmpl,
    num_ant], on ``device`` (default ``config.device``)."""
    dev = config.device if device is None else device
    num_beams = num_ant * oversmpl
    m = np.arange(num_beams)[:, None]
    n = np.arange(num_ant)[None, :]
    gob = np.exp(2j * PI * n * m / num_beams) / np.sqrt(num_ant)
    return torch.as_tensor(gob, device=dev).to(_cdtype(precision))


def grid_of_beams_dft(num_ant_v, num_ant_h, oversmpl_v=1, oversmpl_h=1,
                      precision=None, device=None):
    """2D DFT grid of beams, the Kronecker product of the vertical and
    horizontal ULA codebooks: [num_beams_v, num_beams_h,
    num_ant_v * num_ant_h], on ``device`` (default ``config.device``)."""
    gob_v = grid_of_beams_dft_ula(num_ant_v, oversmpl_v, precision, device)
    gob_h = grid_of_beams_dft_ula(num_ant_h, oversmpl_h, precision, device)
    kron = gob_v[:, None, :, None] * gob_h[None, :, None, :]
    return kron.reshape(gob_v.shape[0], gob_h.shape[0], -1)


def flatten_precoding_mat(precoding_mat, by_column=True):
    """Flattens the last two dimensions of a precoding matrix (column
    by column, or row by row)."""
    precoding_mat = torch.as_tensor(precoding_mat)
    if by_column:
        precoding_mat = precoding_mat.transpose(-2, -1)
    return precoding_mat.reshape(precoding_mat.shape[:-2] + (-1,))


def normalize_precoding_power(precoding_vec, tx_power_list=None,
                              precision=None):
    """Normalizes precoding vectors [..., M] to unit power, then scales
    them by sqrt of ``tx_power_list``."""
    cdtype = _cdtype(precision)
    vec = _unit_columns(torch.as_tensor(precoding_vec).to(cdtype)[..., None]
                        )[..., 0]
    if tx_power_list is not None:
        power = torch.as_tensor(tx_power_list, device=vec.device)
        vec = vec * torch.sqrt(power)[..., None].to(cdtype)
    return vec
