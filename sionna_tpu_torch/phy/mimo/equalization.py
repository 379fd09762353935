"""MIMO equalization (counterpart of ``sionna_tpu/phy/mimo/equalization.py``:
the LMMSE, ZF and MF equalizers; the JAX package's plane functions are
TPU layout work and are left out).

Cholesky-based: two triangular solves per resource element, unrolled
for small matrices (see ``utils.linalg``). While a ``Profiler`` is
active, each call of an equalizer is a span of its name.

On a card, the whitened LMMSE for a noise covariance shared by the whole
batch (at most 16 receive antennas, 4 streams) is one launch of the
hand-written kernel ``csrc/lmmse_whitened.cu``; :func:`lmmse_kernel_applies`
states the rule. Every other call runs :func:`lmmse_equalizer_plain`.
"""

import ctypes

import torch

from ..._build import CudaKernel
from ..config import config, dtypes
from ..utils.linalg import _adjoint, _matmul, batched_cholesky, \
    cholesky_solve, matrix_pinv
from ..utils.profiling import traced
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


@traced("lmmse_equalizer")
def lmmse_equalizer(y, h, s, whiten_interference=True, precision=None):
    """LMMSE equalization: returns (x_hat, no_eff) with the unbiased
    diag(GH)^{-1} scaling.

    Where :func:`lmmse_kernel_applies` holds (whitening on, complex64 on a
    card, one S for the whole batch, M <= 16, K <= 4, no gradient), one
    launch of :func:`lmmse_whitened_cuda` over the flattened batch; there
    a non-positive-definite S gives NaN where :func:`lmmse_equalizer_plain`
    raises (``torch.linalg.cholesky``), as the JAX package's
    ``jnp.linalg.cholesky`` gives NaN. Otherwise
    :func:`lmmse_equalizer_plain`."""
    cdtype = _cdtype(precision)
    y = torch.as_tensor(y).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    s = torch.as_tensor(s).to(cdtype)
    if not lmmse_kernel_applies(y, h, s, whiten_interference):
        return lmmse_equalizer_plain(y, h, s, whiten_interference,
                                     precision)
    m, k = h.shape[-2:]
    # (torch.broadcast_shapes would import torch._refs at its first call:
    # seconds of a process's set-up)
    batch = torch.broadcast_tensors(y[..., 0], h[..., 0, 0],
                                    s[..., 0, 0])[0].shape
    x_hat, no_eff = lmmse_whitened_cuda(
        y.expand(batch + (m,)).reshape(-1, m).contiguous(),
        h.expand(batch + (m, k)).reshape(-1, m, k).contiguous(),
        s[(0,) * (s.dim() - 2)].contiguous())
    return x_hat.reshape(batch + (k,)), no_eff.reshape(batch + (k,))


def lmmse_equalizer_plain(y, h, s, whiten_interference=True,
                          precision=None):
    """:func:`lmmse_equalizer` in plain PyTorch: the whitening by the
    inverse Cholesky factor of S, then G = (H^H H + I)^{-1} H^H (else G =
    H^H (H H^H + S)^{-1}), through ``utils.linalg``."""
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


# the largest M and K the kernel takes: M reaches it as a define, K is that
# of its switch over K (one variant each for 1 to 4)
_KERNEL_MAX_M, _KERNEL_MAX_K = 16, 4
#: The CUDA kernel of the whitened LMMSE for a shared S (built on first
#: use).
LMMSE_WHITENED_KERNEL = CudaKernel(
    name="lmmse_whitened",
    source="lmmse_whitened.cu",
    replaces=None,
    functions={
        "sionna_lmmse_whitened": ([ctypes.c_void_p] * 5
                                  + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p],
                                  ctypes.c_int),
        "sionna_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    defines={"SIONNA_LMMSE_MAX_M": _KERNEL_MAX_M})


def lmmse_kernel_applies(y, h, s, whiten_interference):
    """Whether :func:`lmmse_equalizer` runs the kernel on y [..., M], h
    [..., M, K] and s [..., M, M]: whitening on; all three complex64 on a
    card; S one matrix for the whole batch (each batch dimension of size 1
    or stride 0); 1 <= M <= 16 and 1 <= K <= 4; and no gradient to keep
    (grad mode off, or no input requiring one). Reads only the inputs'
    device, dtype, shape, strides and ``requires_grad``."""
    m, k = h.shape[-2:]
    return bool(
        whiten_interference
        and all(t.device.type == "cuda" and t.dtype == torch.complex64
                for t in (y, h, s))
        and all(size == 1 or stride == 0
                for size, stride in zip(s.shape[:-2], s.stride()[:-2]))
        and 1 <= m <= _KERNEL_MAX_M and 1 <= k <= _KERNEL_MAX_K
        and not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in (y, h, s))))


@traced("lmmse.kernel")
def lmmse_whitened_cuda(y, h, s):
    """The whitened LMMSE of :func:`lmmse_equalizer` by one launch of the
    CUDA kernel ``csrc/lmmse_whitened.cu`` on the current stream: y [N,
    M], h [N, M, K] and the noise covariance s [M, M] that all N channel
    uses share, complex64 and contiguous on one card, 1 <= M <= 16, 1 <= K
    <= 4 -> (x_hat [N, K] complex64, no_eff [N, K] float32). A
    non-positive-definite s gives NaN. Raises ``ValueError`` on anything
    the kernel does not take."""
    kern = LMMSE_WHITENED_KERNEL
    ok = y.dim() == 2 and h.dim() == 3 and s.dim() == 2 \
        and tuple(h.shape[:2]) == tuple(y.shape) \
        and tuple(s.shape) == (y.shape[1], y.shape[1]) \
        and 1 <= y.shape[1] <= _KERNEL_MAX_M \
        and 1 <= h.shape[2] <= _KERNEL_MAX_K \
        and all(t.dtype == torch.complex64 and t.is_cuda
                and t.device == y.device and t.is_contiguous()
                for t in (y, h, s))
    if not ok:
        raise ValueError(
            f"{kern.name}: y {y.dtype} {tuple(y.shape)} on {y.device}, h "
            f"{h.dtype} {tuple(h.shape)} on {h.device}, s {s.dtype} "
            f"{tuple(s.shape)} on {s.device}: not a layout the kernel takes")
    (n, m), k = y.shape, h.shape[2]
    x_hat = torch.empty((n, k), dtype=torch.complex64, device=y.device)
    no_eff = torch.empty((n, k), dtype=torch.float32, device=y.device)
    if n == 0:
        return x_hat, no_eff
    lib = kern.library()
    with torch.cuda.device(y.device):
        err = lib.sionna_lmmse_whitened(
            y.data_ptr(), h.data_ptr(), s.data_ptr(), x_hat.data_ptr(),
            no_eff.data_ptr(), n, m, k,
            torch.cuda.current_stream().cuda_stream)
    kern.check(err)
    kern.count("c64")
    return x_hat, no_eff


@traced("zf_equalizer")
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


@traced("mf_equalizer")
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
