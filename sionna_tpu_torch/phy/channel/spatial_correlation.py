"""Spatial correlation models (counterpart of
``sionna_tpu/phy/channel/spatial_correlation.py``).

The matrix square roots are taken once on the host (NumPy ``eigh``,
negative eigenvalues clipped to 0, as in the JAX package) when a
correlation matrix is set, and kept as tensors on the device of the
matrix given (that of ``device``, else ``config.device``, for a NumPy
one); a call moves them only if the channel lies elsewhere.
"""

import numpy as np
import torch

from ..block import Object
from ..config import config

__all__ = ["SpatialCorrelation", "KroneckerModel", "PerColumnModel"]


class SpatialCorrelation(Object):
    """Abstract spatial correlation applied to [..., M, K] channels."""

    def __call__(self, h, *args, **kwargs):
        raise NotImplementedError


def _host_and_device(value, device):
    """(NumPy copy, device) of a correlation matrix given as an array or
    a tensor."""
    if isinstance(value, torch.Tensor):
        dev = value.device if device is None else torch.device(device)
        return value.detach().cpu().numpy(), dev
    return np.asarray(value), config.device if device is None \
        else torch.device(device)


class KroneckerModel(SpatialCorrelation):
    """Kronecker correlation: h <- R_rx^{1/2} h (R_tx^{1/2})^T, the
    arguments in the order (r_tx, r_rx)."""

    def __init__(self, r_tx=None, r_rx=None, device=None):
        super().__init__()
        self._device = device
        self.r_rx = r_rx
        self.r_tx = r_tx

    @property
    def r_rx(self):
        return self._r_rx

    @r_rx.setter
    def r_rx(self, value):
        self._r_rx, self._r_rx_sqrt = _set_corr(value, self._device)

    @property
    def r_tx(self):
        return self._r_tx

    @r_tx.setter
    def r_tx(self, value):
        self._r_tx, self._r_tx_sqrt = _set_corr(value, self._device)

    def __call__(self, h):
        h = torch.as_tensor(h)
        if self._r_rx_sqrt is not None:
            h = torch.matmul(self._r_rx_sqrt.to(h.device, h.dtype), h)
        if self._r_tx_sqrt is not None:
            h = torch.matmul(h, self._r_tx_sqrt.to(h.device, h.dtype)
                             .transpose(-2, -1))
        return h


class PerColumnModel(SpatialCorrelation):
    """Per-column receive correlation: column k of h [..., M, K] gets its
    own R_rx^{1/2}, from ``r_rx`` [..., K, M, M]."""

    def __init__(self, r_rx, device=None):
        super().__init__()
        self._device = device
        self.r_rx = r_rx

    @property
    def r_rx(self):
        return self._r_rx

    @r_rx.setter
    def r_rx(self, value):
        self._r_rx, self._r_rx_sqrt = _set_corr(value, self._device)

    def __call__(self, h):
        h = torch.as_tensor(h)
        hc = h.transpose(-2, -1)[..., None]  # [..., K, M, 1]
        hc = torch.matmul(self._r_rx_sqrt.to(h.device, h.dtype), hc)
        return hc[..., 0].transpose(-2, -1)


def _set_corr(value, device):
    """(matrix as given, its square root on the device), or (None,
    None)."""
    if value is None:
        return None, None
    host, dev = _host_and_device(value, device)
    return value, torch.as_tensor(_matrix_sqrt(host), device=dev)


def _matrix_sqrt(r):
    """Square root of Hermitian positive semi-definite matrices by their
    eigendecomposition (host NumPy)."""
    r = np.asarray(r)
    w, v = np.linalg.eigh(r)
    w = np.maximum(w, 0)
    sqrt_w = np.sqrt(w).astype(r.dtype)
    return np.matmul(v * sqrt_w[..., None, :],
                     np.conj(np.swapaxes(v, -2, -1)))
