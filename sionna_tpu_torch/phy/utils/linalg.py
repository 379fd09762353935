"""Linear-algebra helpers (counterpart of ``sionna_tpu/phy/utils/linalg.py``).

Per-resource-element MIMO systems are tiny (1x1 at the flagship link,
for some 7 million resource elements per batch), so Cholesky
factorisations, triangular solves and products with a trailing
dimension of at most ``_SMALL_M`` are unrolled into elementwise tensor
arithmetic, as in the JAX package: a batched library routine on
millions of tiny matrices is slow on a GPU as on a TPU (the flagship's
LMMSE stage at batch 2048 took 1.8 ms with the unrolled product and
36.3 ms with ``torch.matmul`` on an H100 at 700 W, same outputs). Above
``_SMALL_M`` the ``torch.linalg`` routines and ``torch.matmul`` are used.
"""

import torch

__all__ = ["small_cholesky", "batched_cholesky", "solve_triangular_lower",
           "cholesky_solve", "inv_cholesky", "matrix_pinv"]

# Largest trailing dimension handled by the unrolled versions.
_SMALL_M = 4


def _stack_rows(rows):
    """[[...m entries...] x m] -> [..., m, m]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def small_cholesky(a):
    """Unrolled Cholesky factor L (lower) of [..., m, m] Hermitian PD
    matrices for m <= 4; elementwise over all batch dims."""
    m = a.shape[-1]
    zero = torch.zeros_like(a[..., 0, 0])
    l = [[zero] * m for _ in range(m)]
    for j in range(m):
        s = a[..., j, j]
        for p in range(j):
            s = s - l[j][p] * torch.conj(l[j][p])
        ljj = torch.sqrt(s.real if s.is_complex() else s).to(a.dtype)
        l[j][j] = ljj
        for i in range(j + 1, m):
            v = a[..., i, j]
            for p in range(j):
                v = v - l[i][p] * torch.conj(l[j][p])
            l[i][j] = v / ljj
    return _stack_rows(l)


def _small_solve_lower(l, b):
    """Solves L y = b for lower-triangular [..., m, m] L and
    [..., m, k] b, unrolled over m."""
    m = l.shape[-1]
    y = [None] * m
    for i in range(m):
        v = b[..., i, :]
        for p in range(i):
            v = v - l[..., i, p, None] * y[p]
        y[i] = v / l[..., i, i, None]
    return torch.stack(y, dim=-2)


def _small_solve_upper_adj(l, b):
    """Solves L^H x = b (L lower-triangular), unrolled over m."""
    m = l.shape[-1]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        v = b[..., i, :]
        for p in range(i + 1, m):
            v = v - torch.conj(l[..., p, i, None]) * x[p]
        x[i] = v / torch.conj(l[..., i, i, None])
    return torch.stack(x, dim=-2)


def _adjoint(x):
    """Conjugate transpose of the two trailing dimensions."""
    return torch.conj(x.transpose(-2, -1))


def _matmul(a, b):
    """[..., m, k] @ [..., k, n] with broadcast batch dims; unrolled
    over k for 1 <= k <= 4, ``torch.matmul`` otherwise."""
    k = a.shape[-1]
    if not 1 <= k <= _SMALL_M:
        return torch.matmul(a, b)
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for p in range(1, k):
        out = out + a[..., :, p:p + 1] * b[..., p:p + 1, :]
    return out


def batched_cholesky(a):
    """Cholesky factor of [..., m, m] Hermitian PD matrices; unrolled
    for m <= 4, ``torch.linalg.cholesky`` above."""
    if a.shape[-1] <= _SMALL_M:
        return small_cholesky(a)
    return torch.linalg.cholesky(a)


def solve_triangular_lower(l, b):
    """Solves L y = b with L lower-triangular, [..., m, k] RHS."""
    if l.shape[-1] <= _SMALL_M:
        return _small_solve_lower(l, b)
    return torch.linalg.solve_triangular(l, b, upper=False)


def cholesky_solve(chol, b):
    """Solves A x = b given the lower Cholesky factor of A."""
    if chol.shape[-1] <= _SMALL_M:
        return _small_solve_upper_adj(chol, _small_solve_lower(chol, b))
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(_adjoint(chol), y, upper=True)


def inv_cholesky(tensor):
    """Inverse ``L^{-1}`` of the Cholesky factor of a batch of Hermitian
    positive-definite matrices: returns ``L^{-1}`` with
    ``tensor = L L^H``."""
    tensor = torch.as_tensor(tensor)
    l = batched_cholesky(tensor)
    eye = torch.eye(tensor.shape[-1], dtype=tensor.dtype,
                    device=tensor.device).expand(l.shape)
    return solve_triangular_lower(l, eye)


def matrix_pinv(tensor):
    """Moore-Penrose pseudo-inverse ``(A^H A)^{-1} A^H`` of a batch of
    full-column-rank matrices, through the Cholesky factor of the Gram
    matrix."""
    tensor = torch.as_tensor(tensor)
    gram = _matmul(_adjoint(tensor), tensor)
    l_inv = inv_cholesky(gram)
    return _matmul(_matmul(_adjoint(l_inv), l_inv), _adjoint(tensor))
