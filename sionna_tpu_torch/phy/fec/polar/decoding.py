"""Polar decoding: SC, SCL, BP and the 5G wrapper.

PyTorch counterpart of ``sionna_tpu/phy/fec/polar/decoding.py``.

- The per-bit SC and SCL decoders (``_sc_decode_single``,
  ``_scl_decode_single``) are the references the tests hold the fast
  decoders against: a Python loop over the bits, batched over leading
  dimensions.
- The fast decoders walk the pruned decoding tree eagerly. The tree is
  classified once per decoder, at construction, from the frozen set
  (``_sc_plan``, ``_scl_plan``): rate-0, rate-1, repetition and (opt-in)
  single-parity-check nodes are decoded in one vectorized step each.
- SCL keeps its paths lazily: a fork composes a pending ``[B, L]`` index
  per live buffer (one ``gather`` over all of them, kept stacked), and
  a buffer applies its pending index with one ``gather`` when it is next
  read. The JAX package does the same with one-hot ``[B, L, L]``
  contractions; each output row of those sums exactly one term, so the
  values are the same.
- Path selection is a stable sort of the 2L candidate metrics
  ``[u=0 paths ; u=1 paths]`` and its first L, so equal metrics keep the
  lower candidate index first, as XLA's TopK does (``torch.topk``
  promises no order among ties).
- ``_boxplus`` keeps the JAX package's exact formula with the +-30 clip.
"""

import numbers
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ...block import Block
from ..crc import CRCEncoder, CRCDecoder
from .encoding import Polar5GEncoder, polar_transform

__all__ = ["PolarSCDecoder", "PolarSCLDecoder", "PolarBPDecoder",
           "Polar5GDecoder"]

_LLR_MAX = 30.0


def _boxplus(x, y):
    """Exact check-node operation with +-30 clipping, in the JAX
    package's form."""
    x = torch.clamp(x, -_LLR_MAX, _LLR_MAX)
    y = torch.clamp(y, -_LLR_MAX, _LLR_MAX)
    return (torch.log(1 + torch.exp(x + y))
            - torch.log(torch.exp(x) + torch.exp(y)))


def _g_op(x, y, u):
    return (1 - 2 * u) * x + y


def _softplus(x):
    """log(1 + exp(x)) as ``logaddexp(x, 0)``, the JAX package's
    ``jax.nn.softplus``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _clip(x):
    return torch.clamp(x, -_LLR_MAX, _LLR_MAX)


def _sc_stages(n):
    return int(np.log2(n))


def _partial_sums(i, bls, cur):
    """Stores the decisions ``cur`` of the node just completed at bit
    ``i`` as the left sibling of its first right-hand ancestor, combining
    them with the stored siblings on the way up."""
    for s in range(len(bls)):
        if i % (2 << s) == (1 << s) - 1:
            bls[s] = cur
            return
        cur = torch.cat([torch.remainder(bls[s] + cur, 2), cur], dim=-1)


def _propagate(i, ls, bls, m):
    """Refreshes the node LLRs on the path to leaf ``i``."""
    lp1 = m if i == 0 else (i & -i).bit_length()
    for s in range(lp1, 0, -1):
        half = 1 << (s - 1)
        a, b = ls[s][..., :half], ls[s][..., half:]
        ls[s - 1] = _g_op(a, b, bls[s - 1]) if (i >> (s - 1)) & 1 \
            else _boxplus(a, b)


def _sc_decode_single(llr_ch, frozen_mask_np, n):
    """Per-bit SC decode; ``llr_ch`` [..., n] classic LLRs. Returns the
    hard decisions u_hat [..., n]."""
    m = _sc_stages(n)
    frozen = np.asarray(frozen_mask_np) > 0
    lead = tuple(llr_ch.shape[:-1])
    ls = [llr_ch.new_zeros(lead + (1 << s,)) for s in range(m)] + [llr_ch]
    bls = [llr_ch.new_zeros(lead + (1 << s,)) for s in range(m)]
    u = llr_ch.new_zeros(lead + (n,))
    for i in range(n):
        _propagate(i, ls, bls, m)
        u_i = torch.zeros_like(ls[0][..., 0]) if frozen[i] \
            else (ls[0][..., 0] < 0).to(llr_ch.dtype)
        u[..., i] = u_i
        _partial_sums(i, bls, u_i[..., None])
    return u


def _select(x, parents):
    """Rows of ``x`` [B, L, ...] reordered by ``parents`` [B, L]."""
    if x.dim() == 2:
        return torch.gather(x, 1, parents)
    idx = parents.reshape(parents.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(parents.shape + x.shape[2:]))


def _prune(pm0, pm1, list_size):
    """Keeps the L best of the 2L candidates ``[pm0 ; pm1]`` (stable on
    ties). Returns (path metrics, decisions, parents)."""
    vals, idx = torch.sort(torch.cat([pm0, pm1], dim=-1), dim=-1,
                           stable=True)
    idx = idx[..., :list_size]
    return (vals[..., :list_size], (idx >= list_size).to(pm0.dtype),
            torch.remainder(idx, list_size))


def _initial_pm(lead, list_size, dtype, device):
    """0 for path 0, 1e9 for the inactive duplicates."""
    pm = torch.full((list_size,), 1e9, dtype=dtype, device=device)
    pm[0] = 0.
    return pm.expand(lead + (list_size,)).clone()


def _scl_decode_single(llr_ch, frozen_mask_np, n, list_size):
    """Per-bit SCL decode; ``llr_ch`` [..., n] classic LLRs. Returns
    (u_hat [..., L, n], pm [..., L])."""
    m = _sc_stages(n)
    frozen = np.asarray(frozen_mask_np) > 0
    lead = tuple(llr_ch.shape[:-1])
    flat = llr_ch.reshape(-1, n)
    bsz, dt = flat.shape[0], llr_ch.dtype
    ls = [flat.new_zeros((bsz, list_size, 1 << s)) for s in range(m)] \
        + [flat[:, None, :].expand(bsz, list_size, n)]
    bls = [flat.new_zeros((bsz, list_size, 1 << s)) for s in range(m)]
    u = flat.new_zeros((bsz, list_size, n))
    pm = _initial_pm((bsz,), list_size, dt, flat.device)
    for i in range(n):
        _propagate(i, ls, bls, m)
        llr0 = _clip(ls[0][..., 0])
        pm0 = pm + _softplus(-llr0)
        if frozen[i]:
            u_i, pm = torch.zeros_like(llr0), pm0
        else:
            pm, u_i, parents = _prune(pm0, pm + _softplus(llr0), list_size)
            ls = [_select(a, parents) for a in ls]
            bls = [_select(a, parents) for a in bls]
            u = _select(u, parents)
        u[..., i] = u_i
        _partial_sums(i, bls, u_i[..., None])
    return (u.reshape(lead + (list_size, n)),
            pm.reshape(lead + (list_size,)))


# ------------------------------------------------------------------ #
# Fast SSC / SSCL: the decoding tree, pruned on the host once per code
# ------------------------------------------------------------------ #

def _sc_plan(frozen, s, lo, use_spc):
    """The fast-SSC tree of the node of width 2^s at bit ``lo``: a tuple
    (kind,) for a rate-0, rate-1, repetition or SPC node, ("split",
    left, right) otherwise."""
    w = 1 << s
    sub = frozen[lo:lo + w]
    if sub.all():
        return ("rate0",)
    if not sub.any():
        return ("rate1",)
    if sub[:-1].all() and not sub[-1]:
        return ("rep",)
    if use_spc and sub[0] and not sub[1:].any():
        return ("spc",)
    return ("split", _sc_plan(frozen, s - 1, lo, use_spc),
            _sc_plan(frozen, s - 1, lo + w // 2, use_spc))


def _scl_plan(frozen, s, lo, use_fast, use_spc):
    """The fast-SSCL tree of the node of width 2^s at bit ``lo``, in the
    JAX package's order of node rules."""
    w = 1 << s
    sub = frozen[lo:lo + w]
    if use_fast and sub.all():
        return ("rate0",)
    if s == 0:
        return ("frozen",) if sub[0] else ("info",)
    if use_fast and sub[:-1].all() and not sub[-1]:
        return ("rep",)
    if use_fast and use_spc and sub[0] and not sub[1:].any():
        return ("spc",)
    if use_fast and not sub.any():
        return ("rate1",)
    return ("split", _scl_plan(frozen, s - 1, lo, use_fast, use_spc),
            _scl_plan(frozen, s - 1, lo + w // 2, use_fast, use_spc))


def _sc_walk(node, llr):
    kind = node[0]
    if kind == "rate0":
        return torch.zeros_like(llr)
    if kind == "rate1":
        return (llr < 0).to(llr.dtype)
    if kind == "rep":
        bit = (torch.sum(llr, -1, keepdim=True) < 0).to(llr.dtype)
        return bit.expand_as(llr)
    if kind == "spc":
        hard = (llr < 0).to(llr.dtype)
        parity = torch.remainder(torch.sum(hard, -1, keepdim=True), 2)
        amin = torch.argmin(torch.abs(llr), -1)
        flip = F.one_hot(amin, llr.shape[-1]).to(llr.dtype) * parity
        return torch.remainder(hard + flip, 2)
    half = llr.shape[-1] // 2
    a, b = llr[..., :half], llr[..., half:]
    bl = _sc_walk(node[1], _boxplus(a, b))
    br = _sc_walk(node[2], _g_op(a, b, bl))
    return torch.cat([torch.remainder(bl + br, 2), br], dim=-1)


def _fast_sc_decode_batch(llr_ch, frozen_mask_np, n, use_spc=False,
                          plan=None):
    """Batched fast-SSC decode; ``llr_ch`` [B, n] classic LLRs. Returns
    the hard u decisions [B, n], identical to per-bit SC.

    The rate-0, rate-1 and repetition shortcuts are exact for the
    boxplus f (sign(f(a, b)) = sign(a) sign(b)); the SPC shortcut is
    exact only for min-sum, so it is off by default. ``plan`` is the
    code's ``_sc_plan`` (built here when None)."""
    if plan is None:
        plan = _sc_plan(np.asarray(frozen_mask_np) > 0, _sc_stages(n), 0,
                        use_spc)
    return polar_transform(_sc_walk(plan, llr_ch))


class _ListState:
    """The fast-SSCL decoder's per-call state: path metrics, the node
    LLRs ``llr[s]`` and left-sibling bits ``bl[s]`` per stage, the node
    codewords ``bb[s]``, and the pending path selection of every llr and
    bl buffer.

    ``pend[:, 2s]`` (llr) and ``pend[:, 2s + 1]`` (bl) hold, for each
    path l, the row of the stored buffer that path l reads; a fork
    inside a node at stage t composes its parents onto slots 2t + 1 on
    (the bl buffers of stages >= t and the llr buffers of stages > t,
    the live ones), and a read applies and clears its slot."""

    def __init__(self, llr_ch, list_size):
        bsz, n = llr_ch.shape
        m = _sc_stages(n)
        self.lsz, self.m = list_size, m
        self.pm = _initial_pm((bsz,), list_size, llr_ch.dtype,
                              llr_ch.device)
        zeros = [llr_ch.new_zeros((bsz, list_size, 1 << s))
                 for s in range(m)]
        self.bufs = [t for z in zeros for t in (z, z)]  # llr, bl per stage
        self.bb = [None] * (m + 1)
        self.root = llr_ch[:, None, :].expand(bsz, list_size, n)
        self.ident = torch.arange(list_size, device=llr_ch.device)
        self.pend = self.ident.expand(bsz, 2 * m, list_size).clone()
        self.dirty = [False] * (2 * m)

    def fork(self, pm0, pm1, stage):
        """2L -> L selection for a fork inside the node at ``stage``.
        Returns (decisions, parents)."""
        self.pm, bits, parents = _prune(pm0, pm1, self.lsz)
        lo = 2 * stage + 1
        if lo < 2 * self.m:
            tail = self.pend[:, lo:]
            self.pend[:, lo:] = torch.gather(
                tail, 2, parents[:, None, :].expand_as(tail))
            self.dirty[lo:] = [True] * (2 * self.m - lo)
        return bits, parents

    def read(self, slot):
        if self.dirty[slot]:
            self.bufs[slot] = _select(self.bufs[slot], self.pend[:, slot])
            self.pend[:, slot] = self.ident
            self.dirty[slot] = False
        return self.bufs[slot]

    def write(self, slot, value):
        self.bufs[slot] = value
        if self.dirty[slot]:
            self.pend[:, slot] = self.ident
            self.dirty[slot] = False

    def node_llr(self, s):
        return self.root if s == self.m else self.read(2 * s)


def _flip_positions(st, s, h, pos, flips, local):
    """The node codeword: the hard decisions ``h`` with ``flips`` [B, L,
    j] applied at the distinct positions ``pos`` [B, L, j], both read
    through the node's composed selection ``local``."""
    if local is not None:
        h, pos = _select(h, local), _select(pos, local)
    flip = torch.zeros_like(h).scatter_(-1, pos, flips)
    st.bb[s] = torch.remainder(h + flip, 2)


def _scl_walk(st, node, s):
    """Decodes the node of width 2^s whose LLRs are ``st.node_llr(s)``;
    leaves its codeword in ``st.bb[s]``."""
    kind = node[0]
    llr = st.node_llr(s)
    w = 1 << s
    if kind == "rate0":  # Hashemi eq. 26
        st.pm = st.pm + torch.sum(_softplus(-_clip(llr)), dim=-1)
        st.bb[s] = torch.zeros_like(llr)
    elif kind in ("frozen", "info"):
        l0 = _clip(llr[..., 0])
        pm0 = st.pm + _softplus(-l0)
        if kind == "frozen":
            st.pm = pm0
            st.bb[0] = torch.zeros_like(llr)
        else:
            bits, _ = st.fork(pm0, st.pm + _softplus(l0), 0)
            st.bb[0] = bits[..., None]
    elif kind == "rep":  # Hashemi eq. 31
        pm0 = st.pm + torch.sum(_softplus(-_clip(llr)), dim=-1)
        pm1 = st.pm + torch.sum(_softplus(_clip(llr)), dim=-1)
        bits, _ = st.fork(pm0, pm1, s)
        st.bb[s] = bits[..., None].expand(bits.shape + (w,))
    elif kind == "spc":
        # single-parity-check node (SSCL-SPC): min(L, w) - 1 forks over
        # the least reliable positions with a parity-repair flip at the
        # least reliable one give the node-optimal list; flipping bit
        # i_j toggles the parity, so the repair flip at i_0 toggles with
        # the per-path state sigma: delta_j = |l_ij| + (1 - 2 sigma)|l_i0|
        a = torch.abs(_clip(llr))
        h = (llr < 0).to(llr.dtype)
        tau = min(st.lsz, w)
        vals, pos = torch.sort(a, dim=-1, stable=True)
        vals, pos = vals[..., :tau], pos[..., :tau]
        gamma = torch.remainder(torch.sum(h, dim=-1), 2)
        st.pm = st.pm + torch.sum(_softplus(-a), dim=-1) \
            + gamma * vals[..., 0]
        sigma = gamma  # 1 where the i_0 repair flip is active
        flips = llr.new_zeros(vals.shape)
        local = None
        for j in range(1, tau):
            delta = vals[..., j] + (1 - 2 * sigma) * vals[..., 0]
            bits, parents = st.fork(st.pm, st.pm + delta, s)
            vals, flips, sigma = (_select(vals, parents),
                                  _select(flips, parents),
                                  _select(sigma, parents))
            flips[..., j] = bits
            sigma = torch.remainder(sigma + bits, 2)
            local = parents if local is None else _select(local, parents)
        flips[..., 0] = sigma  # the final repair flip at i_0
        _flip_positions(st, s, h, pos, flips, local)
    elif kind == "rate1":
        # Hashemi thm. 2: forking the min(L-1, w) least reliable bits
        # reproduces the per-bit list; every hard decision is charged
        # softplus(-|l|) up front, and flipping bit j then costs |l_j|
        a = torch.abs(_clip(llr))
        h = (llr < 0).to(llr.dtype)
        st.pm = st.pm + torch.sum(_softplus(-a), dim=-1)
        nf = min(st.lsz - 1, w)
        if nf == 0:
            st.bb[s] = h
            return
        vals, pos = torch.sort(a, dim=-1, stable=True)
        vals, pos = vals[..., :nf], pos[..., :nf]
        flips = llr.new_zeros(vals.shape)
        local = None
        for j in range(nf):
            bits, parents = st.fork(st.pm, st.pm + vals[..., j], s)
            vals, flips = _select(vals, parents), _select(flips, parents)
            flips[..., j] = bits
            local = parents if local is None else _select(local, parents)
        _flip_positions(st, s, h, pos, flips, local)
    else:
        half = w // 2
        st.write(2 * (s - 1), _boxplus(llr[..., :half], llr[..., half:]))
        _scl_walk(st, node[1], s - 1)
        st.write(2 * (s - 1) + 1, st.bb[s - 1])
        llr = st.node_llr(s)  # re-read: the left child's forks moved paths
        st.write(2 * (s - 1), _g_op(llr[..., :half], llr[..., half:],
                                    st.read(2 * (s - 1) + 1)))
        _scl_walk(st, node[2], s - 1)
        bl, br = st.read(2 * (s - 1) + 1), st.bb[s - 1]
        st.bb[s] = torch.cat([torch.remainder(bl + br, 2), br], dim=-1)


def _fast_scl_decode_batch(llr_ch, frozen_mask_np, n, list_size,
                           use_fast=True, use_spc=False, plan=None):
    """Batched fast-SSCL decode (rate-0 / repetition / rate-1 pruning
    with exact node path metrics; SPC nodes with ``use_spc``);
    ``llr_ch`` [B, n] classic LLRs. Returns (u [B, L, n], pm [B, L]).
    ``plan`` is the code's ``_scl_plan`` (built here when None)."""
    if plan is None:
        plan = _scl_plan(np.asarray(frozen_mask_np) > 0, _sc_stages(n), 0,
                         use_fast, use_spc)
    st = _ListState(llr_ch, list_size)
    _scl_walk(st, plan, st.m)
    return polar_transform(st.bb[st.m]), st.pm


def _check_code(frozen_pos, n):
    """Validates (frozen_pos, n). Returns (n, frozen_pos, k, info_pos,
    frozen mask)."""
    if not isinstance(n, numbers.Number):
        raise TypeError("n must be a number.")
    n = int(n)
    frozen_pos = np.asarray(frozen_pos)
    if frozen_pos.size and not np.issubdtype(frozen_pos.dtype, np.integer):
        raise TypeError("frozen_pos contains non int.")
    if len(frozen_pos) > n:
        raise ValueError("Num. of elements in frozen_pos cannot be greater "
                         "than n.")
    if np.log2(n) != int(np.log2(n)):
        raise ValueError("n must be a power of 2.")
    mask = np.zeros(n, np.float32)
    mask[frozen_pos.astype(np.int64)] = 1
    return (n, frozen_pos, n - len(frozen_pos),
            np.setdiff1d(np.arange(n), frozen_pos), mask)


class _PolarDecoderBase(Block):
    def __init__(self, frozen_pos, n, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        (self._n, self._frozen_pos, self._k, self._info_pos,
         self._frozen_mask) = _check_code(frozen_pos, n)
        self.register_buffer("_info_index", torch.as_tensor(
            self._info_pos, device=self.device), persistent=False)

    @property
    def n(self):
        return self._n

    @property
    def k(self):
        return self._k

    @property
    def frozen_pos(self):
        return self._frozen_pos

    @property
    def info_pos(self):
        return self._info_pos

    def _info_bits(self, u):
        return torch.index_select(u, -1, self._info_index.to(u.device))


class PolarSCDecoder(_PolarDecoderBase):
    """Successive cancellation decoder (fast SSC, identical decisions to
    per-bit SC).

    Input llr_ch [..., n] as logits; output hard info bits [..., k].
    """

    def __init__(self, frozen_pos, n, precision=None, device=None):
        super().__init__(frozen_pos, n, precision=precision, device=device)
        self._plan = _sc_plan(self._frozen_mask > 0, _sc_stages(self._n), 0,
                              use_spc=False)

    def forward(self, llr_ch, /):
        llr_ch = torch.as_tensor(llr_ch).to(self.rdtype)
        in_shape = llr_ch.shape
        llr = -llr_ch.reshape(-1, self._n)  # logits -> classic LLRs
        u_hat = _fast_sc_decode_batch(llr, self._frozen_mask, self._n,
                                      plan=self._plan)
        return self._info_bits(u_hat).reshape(tuple(in_shape[:-1])
                                              + (self._k,))


class PolarSCLDecoder(_PolarDecoderBase):
    """Successive cancellation list decoder.

    Input llr_ch [..., n] as logits; output hard info bits [..., k] of
    the best path (CRC-aided selection if ``crc_degree`` is set; the
    info bits of each path are first reordered by ``ind_iil_inv`` when
    given). ``use_fast_scl`` selects the pruned-tree decoder (rate-0,
    repetition and rate-1 nodes; rate-1 forks the least reliable bits
    first, so rare blocks decode differently from the per-bit
    schedule), ``use_spc`` also prunes single-parity-check nodes with
    the node-optimal fork rule (better or equal to, not identical with,
    per-bit SCL). ``use_hybrid_sc``, ``cpu_only`` and ``use_scatter``
    are graph workarounds of the reference, accepted for its API and
    without effect.
    """

    def __init__(self, frozen_pos, n, list_size=8, crc_degree=None,
                 use_hybrid_sc=False, use_fast_scl=True, cpu_only=False,
                 use_scatter=False, ind_iil_inv=None,
                 return_crc_status=False, use_spc=False, precision=None,
                 device=None):
        super().__init__(frozen_pos, n, precision=precision, device=device)
        if use_hybrid_sc or cpu_only or use_scatter:
            warnings.warn("use_hybrid_sc/cpu_only/use_scatter have no effect "
                          "in the PyTorch port (output is unchanged)",
                          stacklevel=2)
        if not (isinstance(list_size, int)
                and (list_size & (list_size - 1)) == 0):
            raise ValueError("list_size must be a power of 2.")
        self._use_fast_scl = bool(use_fast_scl)
        self._use_spc = bool(use_spc)
        self._list_size = list_size
        self._return_crc_status = bool(return_crc_status)
        self._ind_iil_inv = ind_iil_inv
        self.register_buffer("_iil_inv_index", None if ind_iil_inv is None
                             else torch.as_tensor(np.asarray(ind_iil_inv),
                                                  device=self.device),
                             persistent=False)
        if crc_degree is not None:
            self._crc_encoder = CRCEncoder(crc_degree, precision=precision,
                                           device=self.device)
            self._k_crc = self._crc_encoder.crc_length
        else:
            self._crc_encoder = None
            self._k_crc = 0
        self._plan = _scl_plan(self._frozen_mask > 0, _sc_stages(self._n), 0,
                               self._use_fast_scl, self._use_spc) \
            if self._use_fast_scl else None

    @property
    def k_crc(self):
        return self._k_crc

    @property
    def list_size(self):
        return self._list_size

    def _select_path(self, u_cand, pm):
        """The output path of every block: CRC-aided if a CRC is set
        (the lowest metric among the paths that pass, else the lowest
        overall), else the lowest metric. ``u_cand`` [B, L, k], ``pm``
        [B, L]. Returns (u_hat [B, k], CRC status [B])."""
        best = torch.argmin(pm, dim=-1)
        if self._crc_encoder is None:
            status = torch.ones(pm.shape[0], dtype=torch.bool,
                                device=pm.device)
        else:
            u_check = u_cand if self._iil_inv_index is None else \
                torch.index_select(u_cand, -1,
                                   self._iil_inv_index.to(u_cand.device))
            k_info = self._k - self._k_crc
            parity = self._crc_encoder.parity(u_check[..., :k_info])
            crc_ok = torch.all(parity == u_check[..., k_info:], dim=-1)
            status = torch.any(crc_ok, dim=-1)
            best_crc = torch.argmin(
                torch.where(crc_ok, pm, torch.full_like(pm, float("inf"))),
                dim=-1)
            best = torch.where(status, best_crc, best)
        u_hat = _select(u_cand, best[:, None])[:, 0]
        return u_hat, status

    def forward(self, llr_ch, /):
        llr_ch = torch.as_tensor(llr_ch).to(self.rdtype)
        in_shape = llr_ch.shape
        llr = -llr_ch.reshape(-1, self._n)
        if self._use_fast_scl:
            u_list, pm = _fast_scl_decode_batch(
                llr, self._frozen_mask, self._n, self._list_size,
                plan=self._plan)
        else:
            u_list, pm = _scl_decode_single(llr, self._frozen_mask, self._n,
                                            self._list_size)
        u_hat, crc_status = self._select_path(self._info_bits(u_list), pm)
        u_hat = u_hat.reshape(tuple(in_shape[:-1]) + (self._k,))
        if self._return_crc_status:
            return u_hat, crc_status.reshape(in_shape[:-1])
        return u_hat


class PolarBPDecoder(_PolarDecoderBase):
    """Iterative belief-propagation decoder on the polar factor graph.

    Input llr_ch [..., n] as logits; output info bits, hard or (with
    ``hard_out=False``) as logits.
    """

    def __init__(self, frozen_pos, n, num_iter=20, hard_out=True,
                 precision=None, device=None):
        super().__init__(frozen_pos, n, precision=precision, device=device)
        self._num_iter = int(num_iter)
        self._hard_out = bool(hard_out)
        self._m = _sc_stages(self._n)
        self.register_buffer("_r0", torch.as_tensor(
            np.where(self._frozen_mask > 0, _LLR_MAX, 0.), device=self.device),
            persistent=False)

    @property
    def num_iter(self):
        return self._num_iter

    def _stage(self, s, x, y):
        """One butterfly update of stage s on [B, n] message arrays:
        returns (upper, lower) [B, n/2^{s+1}, 2^s] rows of ``x``, ``y``."""
        shape = (x.shape[0], self._n >> (s + 1), 2, 1 << s)
        xv, yv = x.reshape(shape), y.reshape(shape)
        return xv[..., 0, :], xv[..., 1, :], yv[..., 0, :], yv[..., 1, :]

    def forward(self, llr_ch, /):
        llr_ch = torch.as_tensor(llr_ch).to(self.rdtype)
        in_shape = llr_ch.shape
        llr = -llr_ch.reshape(-1, self._n)
        batch, m = llr.shape[0], self._m
        # l_msgs[s]: right-to-left messages at stage boundary s (s=m the
        # channel), r_msgs[s]: left-to-right messages (s=0 the frozen
        # prior)
        zeros = llr.new_zeros(llr.shape)
        l_msgs = [zeros] * m + [llr]
        r_msgs = [self._r0.to(llr).expand(batch, self._n)] + [zeros] * m
        for _ in range(self._num_iter):
            for s in range(m):
                r_up, r_low, l_up, l_low = self._stage(s, r_msgs[s],
                                                       l_msgs[s + 1])
                out = torch.stack([_boxplus(r_up, l_low + r_low),
                                   _boxplus(r_up, l_up) + r_low], dim=-2)
                r_msgs[s + 1] = out.reshape(batch, self._n)
            for s in range(m - 1, -1, -1):
                l_up, l_low, r_up, r_low = self._stage(s, l_msgs[s + 1],
                                                       r_msgs[s])
                out = torch.stack([_boxplus(l_up, l_low + r_low),
                                   _boxplus(l_up, r_up) + l_low], dim=-2)
                l_msgs[s] = out.reshape(batch, self._n)
        u = self._info_bits(l_msgs[0] + r_msgs[0])  # classic LLRs
        out = (u < 0).to(self.rdtype) if self._hard_out else -u
        return out.reshape(tuple(in_shape[:-1]) + (self._k,))


class Polar5GDecoder(Block):
    """5G polar decoder with rate recovery.

    Wraps SC, SCL (CRC-aided) or BP and inverts the 5G rate matching of
    an associated :class:`Polar5GEncoder`: received logits are summed
    onto their mother-codeword positions (repetitions in a fixed order),
    punctured positions get 0 and shortened ones -30 (known zeros).
    ``use_spc=True`` (the default, as in the JAX package) prunes SCL's
    single-parity-check nodes with the node-optimal rule; pass False for
    the per-bit reference schedule.
    """

    def __init__(self, enc_polar, dec_type="SC", list_size=8, num_iter=20,
                 return_crc_status=False, use_spc=True, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(enc_polar, Polar5GEncoder):
            raise TypeError("enc_polar must be Polar5GEncoder.")
        if dec_type not in ("SC", "SCL", "hybSCL", "BP"):
            raise ValueError("Unknown dec_type.")
        self._encoder = enc_polar
        self._dec_type = dec_type
        self._return_crc_status = bool(return_crc_status)
        n_polar = enc_polar.n_polar
        frozen_pos = enc_polar.frozen_pos
        dev = self.device
        # inverse input interleaver (downlink) for the CRC-aided selection
        iil = enc_polar.ind_input_int
        ind_iil_inv = None if iil is None else np.argsort(iil)
        if dec_type == "SC":
            self._decoder = PolarSCDecoder(frozen_pos, n_polar,
                                           precision=precision, device=dev)
        elif dec_type in ("SCL", "hybSCL"):
            self._decoder = PolarSCLDecoder(
                frozen_pos, n_polar, list_size=list_size,
                crc_degree=enc_polar.enc_crc.crc_degree,
                ind_iil_inv=ind_iil_inv, use_spc=use_spc,
                return_crc_status=True, precision=precision, device=dev)
        else:
            self._decoder = PolarBPDecoder(frozen_pos, n_polar,
                                           num_iter=num_iter,
                                           precision=precision, device=dev)
        self._crc_decoder = CRCDecoder(enc_polar.enc_crc,
                                       precision=precision, device=dev)
        # rate recovery: mother position p sums the received positions j
        # with rm_ind[j] == p, in increasing j, through a [n_polar, r]
        # gather (a zero slot at index n_target pads the short rows)
        rm_ind = enc_polar.ind_rate_matching
        n_target = enc_polar.n_target
        sources = [np.flatnonzero(rm_ind == p) for p in range(n_polar)]
        reps = max(1, max(len(j) for j in sources))
        gather = np.full((n_polar, reps), n_target, np.int64)
        for p, j in enumerate(sources):
            gather[p, :len(j)] = j
        self._reps = reps
        self.register_buffer("_recover_index", torch.as_tensor(
            gather.reshape(-1), device=dev), persistent=False)
        # shortened positions: codeword bits known to be zero
        if n_target < n_polar and enc_polar.k_polar / n_target > 7 / 16:
            shortened = np.setdiff1d(np.arange(n_polar), np.unique(rm_ind))
        else:
            shortened = np.zeros(0, np.int64)
        self._shortened_pos = shortened
        self.register_buffer("_shortened_index", torch.as_tensor(
            shortened, dtype=torch.int64, device=dev), persistent=False)
        self.register_buffer("_iil_inv_index", None if iil is None
                             else torch.as_tensor(ind_iil_inv, device=dev),
                             persistent=False)

    @property
    def dec_type(self):
        return self._dec_type

    @property
    def decoder(self):
        return self._decoder

    def recover_llrs(self, llr):
        """Logits [B, n_target] -> logits [B, n_polar] on the mother
        codeword."""
        batch = llr.shape[0]
        padded = torch.cat([llr, llr.new_zeros((batch, 1))], dim=-1)
        src = torch.index_select(padded, -1, self._recover_index.to(
            llr.device)).reshape(batch, -1, self._reps)
        llr_mother = src[..., 0]
        for r in range(1, self._reps):
            llr_mother = llr_mother + src[..., r]
        if len(self._shortened_pos):
            llr_mother = llr_mother.index_fill(
                -1, self._shortened_index.to(llr.device), -_LLR_MAX)
        return llr_mother

    def forward(self, llr_ch, /):
        enc = self._encoder
        llr_ch = torch.as_tensor(llr_ch).to(self.rdtype)
        in_shape = llr_ch.shape
        out = self._decoder(self.recover_llrs(
            llr_ch.reshape(-1, enc.n_target)))
        if self._dec_type in ("SCL", "hybSCL"):
            u_crc, crc_status = out
        else:
            u_crc, crc_status = out, None
        if self._iil_inv_index is not None:  # undo the input interleaver
            u_crc = torch.index_select(u_crc, -1,
                                       self._iil_inv_index.to(u_crc.device))
        u_hat, crc_ok = self._crc_decoder(u_crc)
        if crc_status is None:
            crc_status = crc_ok[..., 0]
        u_hat = u_hat.reshape(tuple(in_shape[:-1]) + (enc.k_target,))
        if self._return_crc_status:
            return u_hat, crc_status.reshape(in_shape[:-1])
        return u_hat
