"""MIMO equalization (counterpart of ``sionna_tpu/phy/mimo/equalization.py``:
the LMMSE, ZF and MF equalizers; the JAX package's plane functions are
TPU layout work and are left out).

Cholesky-based: two triangular solves per resource element, unrolled
for small matrices (see ``utils.linalg``).
"""

import torch

from ..config import config, dtypes
from ..utils.linalg import _adjoint, _matmul, batched_cholesky, \
    cholesky_solve, matrix_pinv
from .utils import whiten_channel

__all__ = ["lmmse_matrix", "lmmse_equalizer", "zf_equalizer",
           "mf_equalizer"]


def _cdtype(precision):
    return config.cdtype if precision is None \
        else dtypes[precision]["torch"]["cdtype"]


def lmmse_matrix(h, s=None, precision=None):
    """LMMSE equalization matrix G = H^H (H H^H + S)^{-1}
    (or the stable form (H^H H + I)^{-1} H^H for S = I)."""
    cdtype = _cdtype(precision)
    h = torch.as_tensor(h).to(cdtype)
    if s is not None:
        s = torch.as_tensor(s).to(cdtype)
        chol = batched_cholesky(_matmul(h, _adjoint(h)) + s)
        return _adjoint(cholesky_solve(chol, h))
    eye = torch.eye(h.shape[-1], dtype=cdtype, device=h.device)
    chol = batched_cholesky(_matmul(_adjoint(h), h) + eye)
    return cholesky_solve(chol, _adjoint(h))


def lmmse_equalizer(y, h, s, whiten_interference=True, precision=None):
    """LMMSE equalization: returns (x_hat, no_eff) with the unbiased
    diag(GH)^{-1} scaling."""
    cdtype = _cdtype(precision)
    y = torch.as_tensor(y).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    s = torch.as_tensor(s).to(cdtype)

    if not whiten_interference:
        g = lmmse_matrix(h, s, precision=precision)
    else:
        y, h = whiten_channel(y, h, s, return_s=False)
        g = lmmse_matrix(h, s=None, precision=precision)

    d = torch.diagonal(_matmul(g, h), dim1=-2, dim2=-1)
    gy = _matmul(g, y[..., None])[..., 0]
    x_hat = gy / d
    no_eff = (1 / d - 1).real
    return x_hat, no_eff


def zf_equalizer(y, h, s, precision=None):
    """Zero-forcing equalization, G = (H^H H)^{-1} H^H: returns (x_hat,
    no_eff) with no_eff = diag(G S G^H)."""
    cdtype = _cdtype(precision)
    y = torch.as_tensor(y).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    s = torch.as_tensor(s).to(cdtype)
    g = matrix_pinv(h)
    x_hat = _matmul(g, y[..., None])[..., 0]
    gsg = _matmul(_matmul(g, s), _adjoint(g))
    no_eff = torch.diagonal(gsg, dim1=-2, dim2=-1).real
    return x_hat, no_eff


def mf_equalizer(y, h, s, precision=None):
    """Matched-filter equalization, G = diag(H^H H)^{-1} H^H: returns
    (x_hat, no_eff) with no_eff = |diag((I - GH)(I - GH)^H + G S G^H)|."""
    cdtype = _cdtype(precision)
    y = torch.as_tensor(y).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    s = torch.as_tensor(s).to(cdtype)
    hth = _matmul(_adjoint(h), h)
    d_inv = 1 / torch.diagonal(hth, dim1=-2, dim2=-1)
    g = d_inv[..., None] * _adjoint(h)
    x_hat = _matmul(g, y[..., None])[..., 0]
    gsg = _matmul(_matmul(g, s), _adjoint(g))
    eye = torch.eye(h.shape[-1], dtype=cdtype, device=h.device)
    err = eye - _matmul(g, h)
    err_cov = _matmul(err, _adjoint(err))
    no_eff = torch.abs(torch.diagonal(err_cov + gsg, dim1=-2, dim2=-1))
    return x_hat, no_eff
