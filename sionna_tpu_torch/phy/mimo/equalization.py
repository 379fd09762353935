"""MIMO equalization (counterpart of ``sionna_tpu/phy/mimo/equalization.py``:
the LMMSE, ZF and MF equalizers; the JAX package's plane functions are
TPU layout work and are left out).

Cholesky-based: two triangular solves per resource element, unrolled
for small matrices (see ``utils.linalg``). While a ``Profiler`` is
active, each call of an equalizer is a span of its name.

On a card, the whitened LMMSE for a noise covariance shared by the whole
batch (at most 16 receive antennas, 4 streams) is one launch of the
hand-written kernel ``csrc/lmmse_whitened.cu``; :func:`lmmse_kernel_applies`
states the rule. For a noise covariance of its own at each batch element
(the OFDM detectors', at most 4 receive antennas and 4 streams) it is one
launch of ``csrc/lmmse_per_re.cu``; :func:`lmmse_per_re_kernel_applies`
states that rule. Every other call runs :func:`lmmse_equalizer_plain`.
"""

import ctypes

import torch

from ..._build import CudaKernel
from ..config import config, dtypes
from ..utils.linalg import _SMALL_M, _adjoint, _matmul, batched_cholesky, \
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
    ``jnp.linalg.cholesky`` gives NaN. Where
    :func:`lmmse_per_re_kernel_applies` holds (the same, but an S of its
    own at each batch element, M <= 4), one launch of
    :func:`lmmse_per_re_cuda` on the broadcast inputs, read where they lie.
    Otherwise :func:`lmmse_equalizer_plain`."""
    cdtype = _cdtype(precision)
    y = torch.as_tensor(y).to(cdtype)
    h = torch.as_tensor(h).to(cdtype)
    s = torch.as_tensor(s).to(cdtype)
    shared = lmmse_kernel_applies(y, h, s, whiten_interference)
    if not (shared or lmmse_per_re_kernel_applies(y, h, s,
                                                  whiten_interference)):
        return lmmse_equalizer_plain(y, h, s, whiten_interference,
                                     precision)
    m, k = h.shape[-2:]
    # (torch.broadcast_shapes would import torch._refs at its first call:
    # seconds of a process's set-up)
    batch = torch.broadcast_tensors(y[..., 0], h[..., 0, 0],
                                    s[..., 0, 0])[0].shape
    if not shared:
        return lmmse_per_re_cuda(y.expand(batch + (m,)),
                                 h.expand(batch + (m, k)),
                                 s.expand(batch + (m, m)))
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


# the batch dimensions the per-RE kernel walks outside its innermost one
_PER_RE_ROW_DIMS = 3
#: The CUDA kernel of the whitened LMMSE for an S at each batch element
#: (built on first use); M and K up to ``utils.linalg``'s ``_SMALL_M``, one
#: instance each.
LMMSE_PER_RE_KERNEL = CudaKernel(
    name="lmmse_per_re",
    source="lmmse_per_re.cu",
    replaces=None,
    functions={
        "sionna_lmmse_per_re": ([ctypes.c_void_p] * 5
                                + [ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p],
                                ctypes.c_int),
        "sionna_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    defines={"SIONNA_LMMSE_PER_RE_MAX_DIM": _SMALL_M,
             "SIONNA_LMMSE_PER_RE_ROW_DIMS": _PER_RE_ROW_DIMS})


def lmmse_per_re_kernel_applies(y, h, s, whiten_interference):
    """Whether :func:`lmmse_equalizer` runs the per-RE kernel on y [...,
    M], h [..., M, K] and s [..., M, M]: whitening on; all three complex64
    on a card; S not one matrix for the whole batch (some batch dimension
    of size above 1 with a stride other than 0); 1 <= M <= 4 and 1 <= K <=
    4; and no gradient to keep (grad mode off, or no input requiring one).
    Reads only the inputs' device, dtype, shape, strides and
    ``requires_grad``."""
    m, k = h.shape[-2:]
    return bool(
        whiten_interference
        and all(t.device.type == "cuda" and t.dtype == torch.complex64
                for t in (y, h, s))
        and not all(size == 1 or stride == 0
                    for size, stride in zip(s.shape[:-2], s.stride()[:-2]))
        and 1 <= m <= _SMALL_M and 1 <= k <= _SMALL_M
        and not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in (y, h, s))))


def per_re_layout(y, h, s):
    """How :func:`lmmse_per_re_cuda`'s kernel walks the common batch of y
    [*B, M], h [*B, M, K] and s [*B, M, M]: the batch's dimensions of size
    above 1, each merged into the next inner one where all three inputs'
    strides allow, give the columns (the innermost) and up to three row
    dimensions. Returns the kernel's int64 layout (the columns, the row
    sizes innermost first, then for y, h and s the column stride, the
    three row strides and the strides of the element's two indices, in
    complex values), or None where more than four dimensions remain."""
    nb = y.dim() - 1
    dims = []  # innermost first: [size, strides of y, h, s]
    for d in range(nb - 1, -1, -1):
        size = y.shape[d]
        if size == 1:
            continue
        strides = [t.stride(d) for t in (y, h, s)]
        if dims and all(st == inner * dims[-1][0] for st, inner
                        in zip(strides, dims[-1][1])):
            dims[-1][0] *= size
        else:
            dims.append([size, strides])
    if len(dims) > 1 + _PER_RE_ROW_DIMS:
        return None
    dims += [[1, [0, 0, 0]]] * (1 + _PER_RE_ROW_DIMS - len(dims))
    elems = ((y.stride(-1), 0), (h.stride(-2), h.stride(-1)),
             (s.stride(-2), s.stride(-1)))
    layout = [size for size, _ in dims]
    for t, elem in enumerate(elems):
        layout += [strides[t] for _, strides in dims] + list(elem)
    return layout


@traced("lmmse.kernel_per_re")
def lmmse_per_re_cuda(y, h, s):
    """The whitened LMMSE of :func:`lmmse_equalizer` for an S at each
    batch element, by one launch of the CUDA kernel ``csrc/lmmse_per_re.cu``
    on the current stream: y [*B, M], h [*B, M, K] and s [*B, M, M] of one
    batch shape B (any strides, 0 where broadcast), complex64 on one card,
    1 <= M, K <= 4 -> (x_hat [*B, K] complex64, no_eff [*B, K] float32).
    A batch of more than four dimensions that do not merge is copied to
    contiguous first. A non-positive-definite S gives NaN. Raises
    ``ValueError`` on anything the kernel does not take."""
    kern = LMMSE_PER_RE_KERNEL
    batch = tuple(y.shape[:-1])
    ok = h.dim() == y.dim() + 1 and s.dim() == y.dim() + 1 \
        and tuple(h.shape[:-1]) == tuple(y.shape) \
        and tuple(s.shape) == tuple(y.shape) + (y.shape[-1],) \
        and 1 <= y.shape[-1] <= _SMALL_M and 1 <= h.shape[-1] <= _SMALL_M \
        and all(t.dtype == torch.complex64 and t.is_cuda
                and t.device == y.device for t in (y, h, s))
    if not ok:
        raise ValueError(
            f"{kern.name}: y {y.dtype} {tuple(y.shape)} on {y.device}, h "
            f"{h.dtype} {tuple(h.shape)} on {h.device}, s {s.dtype} "
            f"{tuple(s.shape)} on {s.device}: not a layout the kernel takes")
    m, k = y.shape[-1], h.shape[-1]
    x_hat = torch.empty(batch + (k,), dtype=torch.complex64, device=y.device)
    no_eff = torch.empty(batch + (k,), dtype=torch.float32, device=y.device)
    if x_hat.numel() == 0:
        return x_hat, no_eff
    layout = per_re_layout(y, h, s)
    if layout is None:
        y, h, s = (t.contiguous() for t in (y, h, s))
        layout = per_re_layout(y, h, s)
    lib = kern.library()
    with torch.cuda.device(y.device):
        err = lib.sionna_lmmse_per_re(
            y.data_ptr(), h.data_ptr(), s.data_ptr(), x_hat.data_ptr(),
            no_eff.data_ptr(), (ctypes.c_longlong * len(layout))(*layout),
            m, k, torch.cuda.current_stream().cuda_stream)
    kern.check(err)
    kern.count(f"{m}x{k}")
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
