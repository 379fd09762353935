"""Gradients through the lifted 5G LDPC decoder.

The JAX package differentiates its lifted engine by XLA's autodiff of
``LDPC5GLiftedBP.decode`` and ``decode_layered`` (``fori_loop``s with
static trip counts); its Pallas kernel has no VJP. This module gives the
port's lifted engine the same gradient as a reverse pass written out by
hand, in two forms that compute the same function:

- the plain torch versions: :func:`flooding_tape_forward` (the flooding
  decode, op for op as ``LDPC5GLiftedBP.decode``, which also returns the
  per-iteration v2c tape) and :func:`flooding_reverse` (dL/dmarg ->
  dL/dllr from the LLRs and the tape); :func:`layered_tape_forward` and
  :func:`layered_reverse` for the layered schedule, whose tape holds each
  iteration's starting posterior and c2v;
- the CUDA kernels that replace them on the card: K5f and K5b
  (``csrc/ldpc_lifted_bp_grad.cu``), K5Lf and K5Lb
  (``csrc/ldpc_layered_bp_grad.cu``), behind :func:`flooding_tape_cuda`,
  :func:`flooding_reverse_cuda`, :func:`layered_tape_cuda` and
  :func:`layered_reverse_cuda`. Every kernel keeps its state on chip. The
  tape kernels are K1 and K3 with a tape: they run K1's and K3's own code
  (``csrc/ldpc_lifted_bp.cuh``, ``csrc/ldpc_layered_bp.cuh``) in K1's and
  K3's layouts and plans (``LDPC5GLiftedBP.k1_layout``, ``k3_layout``),
  store the tape as they go and never read it back. The backward kernels
  run in the layouts that :func:`flooding_grad_layout` and
  :func:`layered_grad_layout` plan.

:class:`LiftedBPFunction` is the ``torch.autograd.Function`` that
``LDPC5GLiftedBP`` calls when the LLRs require grad. On a CUDA tensor its
forward launches the tape kernel and its backward the backward kernel; on
a CPU tensor it runs the plain pair, so the CPU tests run the kernels'
reverse schedule rather than torch's autograd of ``decode``. A CUDA
tensor never takes the plain pair: a failed build or launch raises.

The reverse pass takes JAX's derivatives where the decode is not smooth,
so that it gives ``jax.grad``'s values on every input: ``jnp.clip(x, -c,
c)`` is minimum(c, maximum(-c, x)) and passes 1/2 at |x| = c;
``jnp.minimum`` and ``jnp.maximum`` split a tie 1/2 to each side (a
min-sum chain of ties splits as the chain does); ``jnp.abs`` passes +1 at
0; a ``where`` passes nothing to its unselected side, a sign nothing.

The tapes are float32 on the card: T x E x B x Z x 4 bytes of v2c for T
iterations of E base edges of Z lanes over B codewords (1.28 GB at the
n=2048 x 2000 link at BP-20, 9.91 GB at n=12288 x 2048); the layered tape
holds T x E x B x Z x 4 bytes of c2v and T x C x B x Z x 4 bytes of
posteriors (C base columns).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...._build import CudaKernel
from .decoding import (_F, _I, _K1_DEFINES, _K3_DEFINES, _P,
                       SMEM_PER_BLOCK, SMEM_PER_SM, _check_llrs,
                       _flooding_plan, _flooding_slots, _flooding_tables,
                       _layered_bp_plan, _lifted_cn_phase)

__all__ = ["LiftedBPFunction", "lifted_bp_grad", "flooding_tape_forward",
           "flooding_reverse", "layered_tape_forward", "layered_reverse",
           "flooding_tape_cuda", "flooding_reverse_cuda",
           "layered_tape_cuda", "layered_reverse_cuda",
           "flooding_grad_layout", "layered_grad_layout",
           "FloodingGradLayout", "LayeredGradLayout",
           "LIFTED_BP_GRAD_KERNEL", "LAYERED_BP_GRAD_KERNEL"]

# Limits of the backward kernels' layouts, defined here only (nvcc gets
# them as defines, beside K1's or K3's, whose code the tape kernels run).
# K5b: threads per block (its launch bound: 384 leave a thread 168
# registers for the check node's adjoint), blocks per cluster (the
# portable most), register-edge CN units per thread. Its plan is K1's
# (``K1_PLAN_ARRAYS``).
K5B_MAX_THREADS = 384
K5B_MAX_CLUSTER = 8
K5B_REG_UNITS = 8
# K5Lb: threads per block and the blocks of that size an SM must hold
# (its launch bound: at most 85 registers a thread; the walk's one
# thread per lane is latency-bound, so lanes in flight beat spills). Its
# plan is K3's (``K3_PLAN_ARRAYS``).
K5LB_MAX_THREADS = 384
K5LB_MIN_BLOCKS = 2
#: The warps one SM holds at K5Lb's registers.
K5LB_SM_WARPS = K5LB_MIN_BLOCKS * K5LB_MAX_THREADS // 32
_DEC = "sionna_tpu/phy/fec/ldpc/decoding.py"

#: K5f, the flooding decode with its v2c tape, and K5b, its reverse.
LIFTED_BP_GRAD_KERNEL = CudaKernel(
    name="ldpc_lifted_bp_grad",
    source="ldpc_lifted_bp_grad.cu",
    replaces=f"{_DEC}:1234",
    functions={
        "sionna_ldpc_flooding_tape": ([_P] * 4 + [_I] * 10 + [_F, _F]
                                      + [_I] * 3 + [_P], _I),
        "sionna_ldpc_flooding_reverse": ([_P] * 5 + [_I] * 11
                                         + [_F, _F] + [_I] * 3 + [_P], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    defines={"SIONNA_K5B_MAX_THREADS": K5B_MAX_THREADS,
             "SIONNA_K5B_MAX_CLUSTER": K5B_MAX_CLUSTER,
             "SIONNA_K5B_REG_UNITS": K5B_REG_UNITS, **_K1_DEFINES})

#: K5Lf, the layered decode with its tape, and K5Lb, its reverse.
LAYERED_BP_GRAD_KERNEL = CudaKernel(
    name="ldpc_layered_bp_grad",
    source="ldpc_layered_bp_grad.cu",
    replaces=f"{_DEC}:1203",
    functions={
        "sionna_ldpc_layered_tape": ([_P] * 5 + [_I] * 9 + [_F, _F]
                                     + [_I] * 3 + [_P], _I),
        "sionna_ldpc_layered_reverse": ([_P] * 8 + [_I] * 7
                                        + [_F, _F] + [_I] * 2 + [_P], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    defines={"SIONNA_K5LB_MAX_THREADS": K5LB_MAX_THREADS,
             "SIONNA_K5LB_MIN_BLOCKS": K5LB_MIN_BLOCKS, **_K3_DEFINES})


# ----------------------------------------------------------------------
# JAX's derivatives of the non-smooth operations, as factors.
# ----------------------------------------------------------------------

def _d_clip(x, c):
    """d jnp.clip(x, -c, c) / dx: 1 inside, 1/2 at |x| = c, 0 outside."""
    a = torch.abs(x)
    return torch.where(a < c, 1., torch.where(a == c, 0.5, 0.)).to(x.dtype)


def _d_min(x, y):
    """d jnp.minimum(x, y) / dx (``y`` a tensor or a number)."""
    return torch.where(x < y, 1., torch.where(x == y, 0.5, 0.)).to(x.dtype)


def _d_max0(x):
    """d jnp.maximum(x, 0) / dx."""
    return torch.where(x > 0, 1., torch.where(x == 0, 0.5, 0.)).to(x.dtype)


def _d_abs(x):
    """d jnp.abs(x) / dx: +1 at 0, as JAX's rule."""
    return torch.where(x >= 0, 1., -1.).to(x.dtype)


def _add(acc, x):
    """acc + x, where None stands for zero."""
    return x if acc is None else acc if x is None else acc + x


def _row_adjoint(v2c, g_c2v, masks, eids, full, clip, offset, mode):
    """The reverse of ``_lifted_cn_phase`` for one base row: the gradient
    with respect to the row's v2c messages (list over ``eids`` of [B, Z])
    from the gradient ``g_c2v`` of its c2v messages (same layout; None is
    zero). Recomputes the row's forward values from ``v2c``."""
    d = len(eids)
    ms = [v2c[e] for e in eids]
    ref = ms[0]
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    gs, acts, signs = [], [], []
    for e, m, g in zip(eids, ms, (g_c2v[e] for e in eids)):
        act = None if full[e] else masks[e] > 0
        g = torch.zeros_like(m) if g is None else g
        sgn = torch.where(m < 0, -one, one)
        if act is not None:
            g = g * masks[e]
            sgn = torch.where(act, sgn, one)
        gs.append(g)
        acts.append(act)
        signs.append(sgn)
    sign_tot = signs[0]
    for sgn in signs[1:]:
        sign_tot = sign_tot * sgn
    # gradient of each edge's clamped magnitude before the clip at `clip`
    g_out = [g * sign_tot * sgn for g, sgn in zip(gs, signs)]
    g_in = [None] * d  # d/d(check-node input): t (boxplus) or |m|
    if mode == "boxplus":
        hi = torch.tensor(1 - 1e-7, dtype=ref.dtype, device=ref.device)
        ts = []
        for m, act in zip(ms, acts):
            t = torch.tanh(torch.abs(m) / 2)
            ts.append(t if act is None else torch.where(act, t, one))
        if d == 1:  # the extrinsic is the constant 1 - 1e-7
            return [torch.zeros_like(ms[0])]
        fwd = [ts[0]]
        for t in ts[1:]:
            fwd.append(fwd[-1] * t)
        bwd = [ts[-1]]
        for t in ts[-2::-1]:
            bwd.append(bwd[-1] * t)
        bwd = bwd[::-1]
        g_fwd, g_bwd = [None] * d, [None] * d
        for i in range(d):
            prod = (bwd[1] if i == 0 else fwd[d - 2] if i == d - 1
                    else fwd[i - 1] * bwd[i + 1])
            ext = torch.minimum(prod, hi)
            mag = torch.log1p(ext) - torch.log1p(-ext)
            g_mag = g_out[i] * _d_min(mag, clip)
            g_prod = (g_mag / (1 + ext) + g_mag / (1 - ext)) \
                * _d_min(prod, hi)
            if i == 0:
                g_bwd[1] = _add(g_bwd[1], g_prod)
            elif i == d - 1:
                g_fwd[d - 2] = _add(g_fwd[d - 2], g_prod)
            else:
                g_fwd[i - 1] = _add(g_fwd[i - 1], g_prod * bwd[i + 1])
                g_bwd[i + 1] = _add(g_bwd[i + 1], g_prod * fwd[i - 1])
        # fwd[i] = fwd[i-1] * t[i] and bwd[i] = bwd[i+1] * t[i], reversed
        for i in range(d - 1, 0, -1):
            if g_fwd[i] is not None:
                g_in[i] = _add(g_in[i], g_fwd[i] * fwd[i - 1])
                g_fwd[i - 1] = _add(g_fwd[i - 1], g_fwd[i] * ts[i])
        g_in[0] = _add(g_in[0], g_fwd[0])
        for i in range(d - 1):
            if g_bwd[i] is not None:
                g_in[i] = _add(g_in[i], g_bwd[i] * bwd[i + 1])
                g_bwd[i + 1] = _add(g_bwd[i + 1], g_bwd[i] * ts[i])
        g_in[d - 1] = _add(g_in[d - 1], g_bwd[d - 1])
        # t = tanh(|m| / 2): dt/d|m| = (1 + t)(1 - t) / 2 (unmasked t)
        g_abs = []
        for m, g in zip(ms, g_in):
            t = torch.tanh(torch.abs(m) / 2)
            g_abs.append(None if g is None else g * (1 + t) * (1 - t) / 2)
    else:
        big = torch.tensor(1e30, dtype=ref.dtype, device=ref.device)
        mags = []
        for m, act in zip(ms, acts):
            a = torch.abs(m)
            mags.append(a if act is None else torch.where(act, a, big))
        mins1 = [mags[0]]
        for a in mags[1:]:
            mins1.append(torch.minimum(mins1[-1], a))
        min1 = mins1[-1]
        ws = [torch.where(a > min1, a, big) for a in mags]
        mins2 = [big]
        for w in ws:
            mins2.append(torch.minimum(mins2[-1], w))
        min2 = mins2[-1]
        n_min = sum((a == min1).to(a.dtype) for a in mags)
        g_min1 = g_min2 = None
        for a, g in zip(mags, g_out):
            unique = (a == min1) & (n_min == 1)
            ext = torch.where(unique, min2, min1)
            if offset > 0.:
                g = g * _d_max0(ext - offset)
                ext = torch.clamp(ext - offset, min=0.)
            g = g * _d_min(ext, clip)
            g_min2 = _add(g_min2, torch.where(unique, g, 0.))
            g_min1 = _add(g_min1, torch.where(unique, 0., g))
        # min2 = minimum(... minimum(big, w[0]) ..., w[d-1]), reversed
        for k in range(d - 1, -1, -1):
            prev, z, w = mins2[k], mins2[k + 1], ws[k]
            g_w = g_min2 * (w == z) * torch.where(prev == z, 0.5, 1.)
            g_in[k] = _add(g_in[k], torch.where(mags[k] > min1, g_w, 0.))
            g_min2 = g_min2 * (prev == z) * torch.where(w == z, 0.5, 1.)
        # min1 = minimum(... minimum(a[0], a[1]) ..., a[d-1]), reversed
        for k in range(d - 1, 0, -1):
            prev, z, a = mins1[k - 1], mins1[k], mags[k]
            g_in[k] = _add(g_in[k], g_min1 * (a == z)
                           * torch.where(prev == z, 0.5, 1.))
            g_min1 = g_min1 * (prev == z) * torch.where(a == z, 0.5, 1.)
        g_in[0] = _add(g_in[0], g_min1)
        g_abs = g_in
    out = []
    for m, g, act in zip(ms, g_abs, acts):
        g = torch.zeros_like(m) if g is None else g * _d_abs(m)
        out.append(g if act is None else torch.where(act, g, 0.))
    return out


def _row_grad(lifted, v2c, g_c2v, masks, eids):
    """:func:`_row_adjoint` of base row ``eids`` of ``lifted``'s code."""
    return _row_adjoint(v2c, g_c2v, masks, eids, lifted._edge_full,
                        lifted._llr_max, lifted._offset, lifted._cn_mode)


def _llr_vn(lifted, x):
    """[B, num_vns] -> [B, C_b, Z], zero-padded (variable alignment)."""
    pad = lifted._n_col_blocks * lifted._z - lifted._num_vns
    return F.pad(x, (0, pad)).reshape(x.shape[0], -1, lifted._z)


def _cn_phase(lifted, v2c, masks):
    return _lifted_cn_phase(v2c, masks, lifted._row_edges,
                            len(lifted._edges), lifted._llr_max,
                            lifted._offset, lifted._cn_mode,
                            lifted._edge_full)


# ----------------------------------------------------------------------
# The plain versions.
# ----------------------------------------------------------------------

def flooding_tape_forward(lifted, llr_int, num_iter):
    """The flooding decode of ``lifted`` (an ``LDPC5GLiftedBP``: its
    ``decode``, f32 storage, log1p form) and its tape.

    Returns (marginals [B, num_vns], tape [num_iter, E, B, Z]): tape[t]
    holds the CN-aligned v2c messages that iteration t reads, the carry of
    JAX's ``fori_loop``."""
    tape = llr_int.new_empty((num_iter, len(lifted._edges),
                              llr_int.shape[0], lifted._z))
    return lifted.decode(llr_int, num_iter, tape=tape), tape


def flooding_reverse(lifted, llr_int, tape, g_marg):
    """The reverse of :func:`flooding_tape_forward`: dL/dllr_int [B,
    num_vns] from the LLRs, the tape and dL/dmarginals [B, num_vns].

    Walks the iterations backwards; in each it recomputes the c2v
    messages from the tape (as the decode computed them) and the VN sums,
    then takes the VN phase's reverse (its clips, the rolls inverted) and
    the CN phase's (:func:`_row_adjoint`)."""
    num_iter = tape.shape[0]
    if num_iter == 0:
        return g_marg.clone()
    batch = llr_int.shape[0]
    clip = lifted._llr_max
    edges = lifted._edges
    llr_vn = _llr_vn(lifted, llr_int)
    g_m = _llr_vn(lifted, g_marg)
    masks = list(lifted.masks.to(llr_int.dtype))
    g_llr = [torch.zeros_like(llr_vn[:, 0])
             for _ in range(lifted._n_col_blocks)]
    g_v2c = [None] * len(edges)  # d/d(v2c out of the iteration)
    for it in range(num_iter - 1, -1, -1):
        v2c = list(tape[it])
        c2v = _cn_phase(lifted, v2c, masks)
        g_c2v = [None] * len(edges)
        for c in range(lifted._n_col_blocks):
            eids = lifted._col_edges.get(c, [])
            rolled = [torch.roll(c2v[e], edges[e][2], dims=-1) for e in eids]
            tot = llr_vn[:, c]
            for x in rolled:
                tot = tot + x
            g_tot = (g_m[:, c] * _d_clip(tot, clip) if it == num_iter - 1
                     else torch.zeros_like(tot))
            hs = []
            for e, x in zip(eids, rolled):
                h = None if g_v2c[e] is None else torch.roll(
                    g_v2c[e], edges[e][2], dims=-1) * _d_clip(tot - x, clip)
                hs.append(h)
                g_tot = _add(g_tot, h)
            for e, h in zip(eids, hs):
                g_x = g_tot if h is None else g_tot - h
                g_c2v[e] = torch.roll(g_x, -edges[e][2], dims=-1)
            g_llr[c] = g_llr[c] + g_tot
        g_v2c = [None] * len(edges)
        for eids in lifted._row_edges.values():
            for e, g in zip(eids, _row_grad(lifted, v2c, g_c2v, masks, eids)):
                g_v2c[e] = g
    # v2c of iteration 0 = roll(clip(llr), -s)
    for c in range(lifted._n_col_blocks):
        acc = None
        for e in lifted._col_edges.get(c, []):
            acc = _add(acc, torch.roll(g_v2c[e], edges[e][2], dims=-1))
        if acc is not None:
            g_llr[c] = g_llr[c] + _d_clip(llr_vn[:, c], clip) * acc
    out = torch.stack(g_llr, dim=1).reshape(batch, -1)
    return out[:, :lifted._num_vns]


def layered_tape_forward(lifted, llr_int, num_iter):
    """The layered decode of ``lifted`` (its ``decode_layered``, f32
    storage) and its tape.

    Returns (marginals [B, num_vns], tape_marg [num_iter, C_b, B, Z],
    tape_c2v [num_iter, E, B, Z]): each iteration's starting posterior
    and c2v messages."""
    batch, z = llr_int.shape[0], lifted._z
    tape_m = llr_int.new_empty((num_iter, lifted._n_col_blocks, batch, z))
    tape_c = llr_int.new_empty((num_iter, len(lifted._edges), batch, z))
    marg = lifted.decode_layered(llr_int, num_iter, tape_marg=tape_m,
                                 tape_c2v=tape_c)
    return marg, tape_m, tape_c


def layered_reverse(lifted, llr_int, tape_m, tape_c, g_marg):
    """The reverse of :func:`layered_tape_forward`: dL/dllr_int [B,
    num_vns] from the tapes and dL/dmarginals [B, num_vns].

    For each iteration, backwards: replays its row sweep from the tape
    (the posterior as each row saw it, so every edge's v2c), then walks
    its rows backwards through each row's posterior update, check node
    and v2c subtraction."""
    num_iter = tape_m.shape[0]
    edges = lifted._edges
    n_e = len(edges)
    masks = list(lifted.masks.to(llr_int.dtype))
    g_m = _llr_vn(lifted, g_marg)
    g_post = [g_m[:, c] for c in range(lifted._n_col_blocks)]
    g_c2v = [None] * n_e
    rows = list(lifted._row_edges.items())
    for it in range(num_iter - 1, -1, -1):
        marg = list(tape_m[it])
        c2v_old = list(tape_c[it])
        v2c = [None] * n_e
        for r, eids in rows:
            for e in eids:
                _, c, s = edges[e]
                v2c[e] = torch.roll(marg[c], -s, dims=-1) - c2v_old[e]
            c2v_new = _lifted_cn_phase(
                v2c, masks, {r: eids}, n_e, lifted._llr_max,
                lifted._offset, lifted._cn_mode, lifted._edge_full)
            for e in eids:
                _, c, s = edges[e]
                marg[c] = marg[c] + torch.roll(c2v_new[e] - c2v_old[e], s,
                                               dims=-1)
        for _, eids in reversed(rows):
            g_new, g_pm = [None] * n_e, {}
            for e in eids:
                _, c, s = edges[e]
                g_pm[e] = torch.roll(g_post[c], -s, dims=-1)
                g_new[e] = _add(g_c2v[e], g_pm[e])
            g_v = _row_grad(lifted, v2c, g_new, masks, eids)
            for e, g in zip(eids, g_v):
                _, c, s = edges[e]
                g_post[c] = g_post[c] + torch.roll(g, s, dims=-1)
                g_c2v[e] = -g_pm[e] - g
    out = torch.stack(g_post, dim=1).reshape(llr_int.shape[0], -1)
    return out[:, :lifted._num_vns]


# ----------------------------------------------------------------------
# The CUDA kernels.
# ----------------------------------------------------------------------

def _check_rows_in_order(lifted, name):
    """Raises ValueError unless the edges of ``lifted``'s code are
    numbered row by row, as the gradient's kernel ``name`` takes them: an
    edge's row position in K1's or K3's plan is then its index in the
    tapes."""
    rows = [e for r in range(lifted._n_row_blocks)
            for e in lifted._row_edges.get(r, [])]
    if rows != list(range(len(lifted._edges))):
        raise ValueError(f"{name} takes edges numbered row by row")


class FloodingGradLayout(NamedTuple):
    """How K5b lays out one code's message state on the card (see
    :func:`flooding_grad_layout`)."""

    threads: int          # threads per block
    cluster: int          # blocks per codeword (a thread-block cluster)
    smem_bytes: int       # dynamic shared memory per block
    slab_floats: int      # floats of each of a block's two slabs
    staged: bool          # each iteration's tape rows copied in ahead
    reg_edges: tuple      # edges whose two slots live in registers
    slots: tuple          # per edge: (owner block, index) or None
    reg_units_per_thread: int
    n_reg_rows: int
    n_plain_rows: int
    n_vn_cols: int
    plan: np.ndarray      # int32 tables (K1's) the kernel copies in


def flooding_grad_layout(lifted):
    """The layout of K5b (``csrc/ldpc_lifted_bp_grad.cu``) for the code
    of ``lifted``, K1's (``decoding.lifted_bp_layout``) with two slots
    per edge lane. Plain Python, run once per decoder.

    - Register edges: each base row's first edge whose column has degree
      1; the thread of CN unit (row, lane) keeps that lane's two slots in
      registers and takes the column's VN reverse itself.
    - Every other edge has two f32 slots per lane in shared memory, in
      two slabs: c2v, then dL/dc2v written over it; and dL/dv2c, carried
      from iteration t + 1 to t. When they do not fit one block
      (``SMEM_PER_BLOCK``, with the plan), the codeword takes a cluster of
      2-8 blocks and the shared edges are split into contiguous groups of
      edge ids, one group per block.
    - Cluster: the fewest blocks whose shared memory holds the slabs and
      whose threads hold the register edges' lanes in at most
      ``K5B_REG_UNITS`` units each.
    - Threads: enough for one CN or VN unit each, up to
      ``K5B_MAX_THREADS`` per block.
    - Staged: in one block with room for two more [E, Z] f32 buffers
      (the link's code), each iteration's tape rows are copied into
      shared memory during the iteration before; else the kernel reads
      them from the tape.
    - The plan is K1's (``K1_PLAN_ARRAYS``), its slot ids indexing both
      slabs; edges are numbered row by row, so a row position is the
      edge's index in the tape.

    Raises ValueError for a code that no layout takes (a row degree
    outside ``CN_ROW_DEGREES``, a mask that is not one cyclic range, no
    cluster of up to ``K5B_MAX_CLUSTER`` blocks that holds the state)."""
    z, n_e = lifted._z, len(lifted._edges)
    t = _flooding_tables(lifted, "K5b")
    _check_rows_in_order(lifted, "K5b")
    units = max(len(t.rows), len(t.vn_cols)) * z
    for cluster in range(1, K5B_MAX_CLUSTER + 1):
        per_block = -(-len(t.shared) // cluster)
        smem = (2 * per_block * z + t.plan_len) * 4
        if smem > SMEM_PER_BLOCK:
            continue
        threads = min(K5B_MAX_THREADS, -(-units // (cluster * 32)) * 32)
        per_thread = -(-len(t.reg_rows) * z // (cluster * threads))
        if per_thread <= K5B_REG_UNITS:
            break
    else:
        raise ValueError(
            f"no K5b layout takes this code: {len(t.shared)} shared edges "
            f"and {len(t.reg_rows)} register edges of {z} lanes need more "
            f"than {K5B_MAX_CLUSTER} blocks of {K5B_MAX_THREADS} threads")
    staged = cluster == 1 and smem + 2 * n_e * z * 4 <= SMEM_PER_BLOCK
    slots, per_block = _flooding_slots(t, n_e, cluster)
    return FloodingGradLayout(
        threads=threads, cluster=cluster,
        smem_bytes=smem + (2 * n_e * z * 4 if staged else 0),
        slab_floats=per_block * z, staged=staged, reg_edges=t.reg_edges,
        slots=slots, reg_units_per_thread=per_thread,
        n_reg_rows=len(t.reg_rows), n_plain_rows=len(t.plain_rows),
        n_vn_cols=len(t.vn_cols), plan=_flooding_plan(lifted, t, slots))


class LayeredGradLayout(NamedTuple):
    """How K5Lb lays out one code's state on the card (see
    :func:`layered_grad_layout`)."""

    threads: int          # threads per block (one per codeword): m per lane
    smem_bytes: int       # dynamic shared memory per block
    gc_on_chip: bool      # dL/dc2v in shared memory (else device memory)
    steps: tuple          # row steps: (first row, end row), rows in order
    plan: np.ndarray      # int32 tables (K3's) the kernel copies in


def _layered_blocks_per_sm(smem, threads):
    """Blocks of K5Lb that one SM holds, by their shared memory (and the
    1 KB the card reserves per block) and by the warps its registers
    allow (``K5LB_SM_WARPS``)."""
    return min(SMEM_PER_SM // (smem + 1024),
               K5LB_SM_WARPS // -(-threads // 32))


def layered_grad_layout(lifted):
    """The layout of K5Lb (``csrc/ldpc_layered_bp_grad.cu``) for the code
    of ``lifted``, K3's (``decoding.layered_bp_layout``) with the
    gradient's state, one block per codeword. Plain Python, run once per
    decoder.

    - Row steps: consecutive rows that share no column run as one step
      (``decoding._row_steps``), in order in the replay of an iteration
      and in reverse in its backward walk.
    - Threads: m per lane, each on one lane throughout, m the most rows
      of a step (at most ``K5LB_MAX_THREADS`` threads a block).
    - Shared memory: the plan (K3's, ``K3_PLAN_ARRAYS``), the replayed
      posterior and dL/dpost (f32, Z lanes of each column), and dL/dc2v
      (f32, per edge and lane) where it fits (``SMEM_PER_BLOCK``) and
      keeps as many blocks resident on an SM as device memory does. The
      walk along a codeword's rows is a chain of dependent steps, each a
      few hundred operations per lane on one thread, so the lanes in
      flight set the speed: at the link and at n=12288 dL/dc2v goes to
      device memory (6 blocks an SM at the link, 2 at n=12288), which
      measured fastest (``PERF.md``, Findings). v2c is always in device
      memory ([B, E, Z]).
    - Edges are numbered row by row, so an edge's row position is its
      index in the c2v tape.

    Raises ValueError for a code that no layout takes (a row degree
    outside ``CN_ROW_DEGREES``, a mask that is not one cyclic range, more
    lanes than ``K5LB_MAX_THREADS``, a posterior and dL/dpost too large
    for one block)."""
    z, n_cols, n_e = lifted._z, lifted._n_col_blocks, len(lifted._edges)
    tables = _layered_bp_plan(lifted, "K5Lb")
    _check_rows_in_order(lifted, "K5Lb")
    smem = (tables.plan.size + 2 * n_cols * z) * 4
    if z > K5LB_MAX_THREADS or smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"no K5Lb layout takes this code: {n_cols} columns of {z} "
            f"lanes need {smem} B of shared memory and {z} threads a block")
    per_lane = max(1, min(max(b - a for a, b in tables.steps),
                          K5LB_MAX_THREADS // z))
    threads = per_lane * z
    with_gc = smem + n_e * z * 4
    gc_on_chip = with_gc <= SMEM_PER_BLOCK and \
        _layered_blocks_per_sm(with_gc, threads) >= \
        _layered_blocks_per_sm(smem, threads)
    return LayeredGradLayout(
        threads=threads, smem_bytes=with_gc if gc_on_chip else smem,
        gc_on_chip=gc_on_chip, steps=tables.steps, plan=tables.plan)


def _cached(lifted, key, make):
    """``make()``, kept on ``lifted`` under ``key``: the backward kernels'
    layouts and their plans on each device."""
    cache = lifted._grad_plans
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _padded(lifted, x):
    """[B, num_vns] -> contiguous [B, C_b * Z], zero-padded."""
    pad = lifted._n_col_blocks * lifted._z - lifted._num_vns
    return F.pad(x.detach(), (0, pad)).contiguous()


def _call(kern, fn_name, lifted, device, args, variant):
    """Calls the C entry point ``fn_name`` of ``kern`` with ``args`` and
    the current stream of ``device``, raises on its error and counts the
    launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(kern.library(), fn_name)(*args, stream)
    kern.check(err)
    kern.count(variant + ("+minsum" if lifted._cn_mode == "minsum" else ""))


def _cn_args(lifted):
    """The check node's constants: clip, offset, mode (0 boxplus, 1
    min-sum)."""
    return (lifted._llr_max, lifted._offset,
            0 if lifted._cn_mode == "boxplus" else 1)


def flooding_tape_cuda(lifted, llr_int, num_iter):
    """K5f: :func:`flooding_tape_forward` as one launch of
    ``csrc/ldpc_lifted_bp_grad.cu`` on the current stream, counted as
    "forward". llr_int: f32 CUDA [B, num_vns] on the device of
    ``lifted``'s tables. K5f runs K1's code in K1's layout and plan (the
    message state in shared memory, so nothing but the outputs is
    allocated): its marginals are K1's bit for bit."""
    kern = LIFTED_BP_GRAD_KERNEL
    _check_rows_in_order(lifted, "K5f")
    _check_llrs(kern, lifted, llr_int, num_iter, None, "log1p")
    z, batch, n_e = lifted._z, llr_int.shape[0], len(lifted._edges)
    llr_p = _padded(lifted, llr_int)
    out = torch.empty_like(llr_p)
    tape = llr_p.new_empty((num_iter, n_e, batch, z))
    if batch:
        dev = llr_int.device
        layout, plan = lifted.k1_layout(), lifted.k1_plan(dev)
        _call(kern, "sionna_ldpc_flooding_tape", lifted, dev, (
            llr_p.data_ptr(), plan.data_ptr(), out.data_ptr(),
            tape.data_ptr(), batch, lifted._n_col_blocks, n_e, z,
            layout.n_reg_rows, layout.n_plain_rows, layout.n_vn_cols,
            layout.state_floats, plan.numel(), num_iter, *_cn_args(lifted),
            layout.threads, layout.cluster), "forward")
    return out[:, :lifted._num_vns], tape


def flooding_reverse_cuda(lifted, llr_int, tape, g_marg):
    """K5b: :func:`flooding_reverse` as one launch of
    ``csrc/ldpc_lifted_bp_grad.cu`` on the current stream, in the layout
    of :func:`flooding_grad_layout` (the message state in shared memory,
    so nothing but the output is allocated), counted as "backward"."""
    kern = LIFTED_BP_GRAD_KERNEL
    num_iter = tape.shape[0]
    _check_llrs(kern, lifted, llr_int, num_iter, None, "log1p")
    z, batch, n_e = lifted._z, llr_int.shape[0], len(lifted._edges)
    if tape.shape != (num_iter, n_e, batch, z) or not tape.is_contiguous():
        raise ValueError(f"expected a contiguous tape [{num_iter}, {n_e}, "
                         f"{batch}, {z}], got {tuple(tape.shape)}")
    llr_p = _padded(lifted, llr_int)
    g_p = _padded(lifted, g_marg.to(llr_p.dtype))
    g_llr = torch.empty_like(llr_p)
    if batch:
        dev = llr_int.device
        layout = _cached(lifted, "k5b", lambda: flooding_grad_layout(lifted))
        plan = _cached(lifted, ("k5b", dev),
                       lambda: torch.as_tensor(layout.plan, device=dev))
        _call(kern, "sionna_ldpc_flooding_reverse", lifted, dev, (
            llr_p.data_ptr(), plan.data_ptr(), g_p.data_ptr(),
            tape.data_ptr(), g_llr.data_ptr(), batch, lifted._n_col_blocks,
            n_e, z, layout.n_reg_rows, layout.n_plain_rows,
            layout.n_vn_cols, layout.slab_floats, int(layout.staged),
            plan.numel(), num_iter, *_cn_args(lifted), layout.threads,
            layout.cluster),
            "backward")
    return g_llr[:, :lifted._num_vns]


def layered_tape_cuda(lifted, llr_int, num_iter):
    """K5Lf: :func:`layered_tape_forward` as one launch of
    ``csrc/ldpc_layered_bp_grad.cu`` on the current stream, counted as
    "forward". K5Lf runs K3's code in K3's f32 layout and plan (the
    posterior and c2v in shared memory, so nothing but the outputs is
    allocated): its marginals are K3's bit for bit."""
    kern = LAYERED_BP_GRAD_KERNEL
    _check_rows_in_order(lifted, "K5Lf")
    _check_llrs(kern, lifted, llr_int, num_iter, None, "log1p")
    z, batch, n_e = lifted._z, llr_int.shape[0], len(lifted._edges)
    n_cols = lifted._n_col_blocks
    llr_p = _padded(lifted, llr_int)
    out = torch.empty_like(llr_p)
    tape_m = llr_p.new_empty((num_iter, n_cols, batch, z))
    tape_c = llr_p.new_empty((num_iter, n_e, batch, z))
    if batch:
        dev = llr_int.device
        layout, plan = lifted.k3_layout(None), lifted.k3_plan(dev)
        _call(kern, "sionna_ldpc_layered_tape", lifted, dev, (
            llr_p.data_ptr(), plan.data_ptr(), out.data_ptr(),
            tape_m.data_ptr(), tape_c.data_ptr(), batch, len(layout.steps),
            n_cols, n_e, z, layout.lanes, layout.step_degree, plan.numel(),
            num_iter, *_cn_args(lifted), layout.threads, layout.cluster),
            "forward")
    return out[:, :lifted._num_vns], tape_m, tape_c


def layered_reverse_cuda(lifted, llr_int, tape_m, tape_c, g_marg):
    """K5Lb: :func:`layered_reverse` as one launch of
    ``csrc/ldpc_layered_bp_grad.cu`` on the current stream, in the layout
    of :func:`layered_grad_layout` (the posterior and dL/dpost in shared
    memory; v2c, and dL/dc2v where the layout keeps it in device memory,
    in [B, E, Z] buffers allocated here and not cleared), counted as
    "backward"."""
    kern = LAYERED_BP_GRAD_KERNEL
    num_iter = tape_m.shape[0]
    _check_llrs(kern, lifted, llr_int, num_iter, None, "log1p")
    z, batch, n_e = lifted._z, llr_int.shape[0], len(lifted._edges)
    n_cols = lifted._n_col_blocks
    for name, t, shape in (("tape_m", tape_m, (num_iter, n_cols, batch, z)),
                           ("tape_c", tape_c, (num_iter, n_e, batch, z))):
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"expected a contiguous {name} {list(shape)}, "
                             f"got {tuple(t.shape)}")
    llr_p = _padded(lifted, llr_int)
    g_p = _padded(lifted, g_marg.to(llr_p.dtype))
    g_llr = torch.empty_like(llr_p)
    if batch:
        dev = llr_int.device
        layout = _cached(lifted, "k5lb", lambda: layered_grad_layout(lifted))
        plan = _cached(lifted, ("k5lb", dev),
                       lambda: torch.as_tensor(layout.plan, device=dev))
        shape = (batch, n_e, z) if num_iter else (1,)
        v2c = llr_p.new_empty(shape)
        gc = None if layout.gc_on_chip else llr_p.new_empty(shape)
        _call(kern, "sionna_ldpc_layered_reverse", lifted, dev, (
            llr_p.data_ptr(), plan.data_ptr(), g_p.data_ptr(),
            tape_m.data_ptr(), tape_c.data_ptr(), g_llr.data_ptr(),
            v2c.data_ptr(), None if gc is None else gc.data_ptr(), batch,
            len(layout.steps), n_cols, n_e, z, plan.numel(), num_iter,
            *_cn_args(lifted), layout.threads), "backward")
    return g_llr[:, :lifted._num_vns]


class LiftedBPFunction(torch.autograd.Function):
    """The lifted decode of an ``LDPC5GLiftedBP`` with its gradient:
    ``LiftedBPFunction.apply(llr_int, lifted, num_iter, layered)``.

    CUDA tensors: the forward launches K5f (or K5Lf), whose marginals are
    K1's (K3's), and keeps the tape for the backward, which launches K5b
    (K5Lb). CPU tensors: the plain tape forward and reverse."""

    @staticmethod
    def forward(ctx, llr_int, lifted, num_iter, layered):
        if llr_int.is_cuda:
            run = layered_tape_cuda if layered else flooding_tape_cuda
        elif llr_int.device.type == "cpu":
            run = layered_tape_forward if layered else flooding_tape_forward
        else:
            raise ValueError(f"no lifted BP decoder for {llr_int.device}")
        marg, *tapes = run(lifted, llr_int, num_iter)
        ctx.lifted, ctx.layered = lifted, layered
        ctx.save_for_backward(llr_int, *tapes)
        return marg

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_marg):
        llr_int, *tapes = ctx.saved_tensors
        if llr_int.is_cuda:
            run = layered_reverse_cuda if ctx.layered \
                else flooding_reverse_cuda
        else:
            run = layered_reverse if ctx.layered else flooding_reverse
        return run(ctx.lifted, llr_int, *tapes, g_marg), None, None, None


def lifted_bp_grad(lifted, llr_int, num_iter, layered=False):
    """Marginals [B, num_vns] of the lifted decode of ``llr_int`` [B,
    num_vns] (classic convention) after ``num_iter`` flooding or
    (``layered``) layered iterations, differentiable with respect to
    ``llr_int`` (:class:`LiftedBPFunction`)."""
    return LiftedBPFunction.apply(llr_int, lifted, num_iter, layered)
