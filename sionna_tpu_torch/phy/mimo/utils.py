"""MIMO utilities: complex/real transforms, channel whitening and
candidate-list-to-LLR (counterpart of ``sionna_tpu/phy/mimo/utils.py``)."""

import numpy as np
import torch

from ..block import Block
from ..utils.linalg import _matmul, inv_cholesky

__all__ = ["complex2real_vector", "real2complex_vector",
           "complex2real_matrix", "real2complex_matrix",
           "complex2real_covariance", "real2complex_covariance",
           "complex2real_channel", "real2complex_channel",
           "whiten_channel", "List2LLR", "List2LLRSimple"]


def complex2real_vector(z):
    """[..., M] complex -> [..., 2M] real: [Re(z); Im(z)]."""
    z = torch.as_tensor(z)
    return torch.cat([z.real, z.imag], dim=-1)


def real2complex_vector(z):
    """[..., 2M] real -> [..., M] complex."""
    z = torch.as_tensor(z)
    m = z.shape[-1] // 2
    return torch.complex(z[..., :m], z[..., m:])


def complex2real_matrix(z):
    """[..., M, K] complex -> [..., 2M, 2K] real block form
    [[Re, -Im], [Im, Re]]."""
    z = torch.as_tensor(z)
    re, im = z.real, z.imag
    top = torch.cat([re, -im], dim=-1)
    bot = torch.cat([im, re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def real2complex_matrix(z):
    """Inverse of :func:`complex2real_matrix`."""
    z = torch.as_tensor(z)
    m = z.shape[-2] // 2
    k = z.shape[-1] // 2
    return torch.complex(z[..., :m, :k], z[..., m:, :k])


def complex2real_covariance(r):
    """Covariance of the real-composite representation: [..., 2M, 2M]
    with 1/2 scaling (circular symmetry)."""
    return complex2real_matrix(r) / 2


def real2complex_covariance(q):
    """Inverse of :func:`complex2real_covariance`."""
    q = torch.as_tensor(q)
    m = q.shape[-2] // 2
    return 2 * torch.complex(q[..., :m, :m], q[..., m:, :m])


def complex2real_channel(y, h, s):
    """Real-valued representation of a complex MIMO channel."""
    return (complex2real_vector(y), complex2real_matrix(h),
            complex2real_covariance(s))


def real2complex_channel(y, h, s):
    """Inverse of :func:`complex2real_channel`."""
    return (real2complex_vector(y), real2complex_matrix(h),
            real2complex_covariance(s))


def whiten_channel(y, h, s, return_s=True):
    """Whitens y = Hx + n by L^{-1} with S = L L^H."""
    y = torch.as_tensor(y)
    h = torch.as_tensor(h)
    s = torch.as_tensor(s)
    l_inv = inv_cholesky(s)
    yw = _matmul(l_inv, y[..., None])[..., 0]
    hw = _matmul(l_inv, h)
    if return_s:
        sw = torch.eye(s.shape[-1], dtype=s.dtype,
                       device=s.device).expand(s.shape)
        return yw, hw, sw
    return yw, hw


class List2LLR(Block):
    """Abstract candidate-list-to-LLR computer: called with ``(y, r,
    dists, path_inds, path_syms)``."""

    def forward(self, y, r, dists, path_inds, path_syms):
        raise NotImplementedError


class List2LLRSimple(List2LLR):
    """Max-log LLRs from a candidate list: LLR(k, i) = min over the
    candidates whose bit i of stream k is 0 of their distance, minus the
    same over those where it is 1; +-``llr_clip_val`` where one set is
    empty, and clipped to it."""

    def __init__(self, num_bits_per_symbol, llr_clip_val=20.0,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        self.llr_clip_val = llr_clip_val
        k = self._num_bits_per_symbol
        ints = np.arange(2 ** k)
        shifts = np.arange(k - 1, -1, -1)
        # bits[c, i] in {0, 1}, MSB first (the Mapper's labels)
        self.register_buffer("_bits", torch.as_tensor(
            (ints[:, None] >> shifts[None, :]) & 1, device=self.device),
            persistent=False)

    @property
    def llr_clip_val(self):
        return self._llr_clip_val

    @llr_clip_val.setter
    def llr_clip_val(self, value):
        self._llr_clip_val = float(value)

    def forward(self, y, r, dists, path_inds, path_syms):
        # dists: [..., num_paths]; path_inds: [..., num_paths, S]
        dists = torch.as_tensor(dists).to(self.rdtype)
        path_inds = torch.as_tensor(path_inds).to(torch.int64)
        big = torch.tensor(torch.finfo(self.rdtype).max / 2,
                           dtype=self.rdtype, device=dists.device)
        # bits of each candidate symbol: [..., paths, S, num_bits]
        bits = self._bits.to(dists.device)[path_inds]
        d = dists[..., None, None]
        min0 = torch.amin(torch.where(bits == 0, d, big), dim=-3)
        min1 = torch.amin(torch.where(bits == 1, d, big), dim=-3)
        llr = min0 - min1
        # no candidate with bit 0: +clip; none with bit 1: -clip
        clip = self._llr_clip_val
        llr = torch.where(min0 >= big, torch.full_like(llr, clip), llr)
        llr = torch.where(min1 >= big, torch.full_like(llr, -clip), llr)
        return torch.clamp(llr, -clip, clip)
