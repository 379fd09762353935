"""LDPC belief-propagation decoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/ldpc/decoding.py``:

- the edge-domain update functions (``cn_update_*``, ``vn_update_sum``
  and the identity updates) and :class:`LDPCBPDecoder`, BP over the edge
  list of any parity-check matrix with the "segment" engine (segment
  sums and minima as ``index_add``/``scatter_reduce`` over the edge
  axis) or the "matmul" engine (one-hot incidence products), flooding
  or layered, with callbacks, state round-tripping and bf16 messages.
  Both engines are plain torch, so autograd runs through them;
- :class:`LDPC5GDecoder`, its 5G subclass with rate recovery, which
  takes the lifted engine for the built-in flooding updates (and on
  request for the layered schedule) and the segment engine otherwise;
- :class:`LDPC5GLiftedBP`, the lifted (block-circulant) engine: the
  plain torch decodes, flooding and layered, and the wrappers of the two
  hand-written CUDA kernels that replace the Pallas kernel
  ``_lifted_pallas_decode``: :func:`lifted_bp_cuda` (flooding,
  ``csrc/ldpc_lifted_bp.cu``, in the on-chip layout that
  :func:`lifted_bp_layout` plans) and :func:`layered_bp_cuda` (layered,
  ``csrc/ldpc_layered_bp.cu``, in the on-chip layout that
  :func:`layered_bp_layout` plans), each with the Pallas kernel's bf16
  message storage and (flooding) its ``ratio`` form of the boxplus
  magnitude.

Which lifted decode runs depends only on where the LLRs lie: a CPU
tensor goes through the plain decode, a CUDA tensor through the kernel.
A CUDA tensor never falls back to the plain decode; if the kernel cannot
build or launch, the call raises. LLRs that require grad go through
``lifted_grad.LiftedBPFunction`` instead: the gradient kernels K5f/K5b
and K5Lf/K5Lb on the card, their plain versions on the CPU.

LLRs follow the package logit convention log(P1/P0); the BP engines
work in the classic log(P0/P1) convention (input and output negated).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp_sparse
import torch
import torch.nn.functional as F
from torch import nn

from ...block import Block
from ...config import config
from ...._build import CudaKernel
from .encoding import LDPC5GEncoder

__all__ = ["LDPCBPDecoder", "LDPC5GDecoder", "cn_update_minsum",
           "cn_update_offset_minsum", "cn_update_tanh", "cn_update_phi",
           "vn_update_sum", "cn_node_update_identity",
           "vn_node_update_identity", "LDPC5GLiftedBP", "lifted_bp_cuda",
           "layered_bp_cuda", "lifted_bp_layout", "layered_bp_layout",
           "LiftedBPLayout", "LayeredBPLayout", "LIFTED_BP_KERNEL",
           "LAYERED_BP_KERNEL"]

_LIFTED_CN_UPDATES = ("minsum", "offset-minsum", "boxplus", "boxplus-phi")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: Shared memory one thread block may use on an H100, in bytes.
SMEM_PER_BLOCK = 232_448
#: Shared memory of one SM of an H100, of which each resident block takes
#: 1 KB besides its own, in bytes.
SMEM_PER_SM = 233_472
# Limits of the kernels' layouts. They are defined here only: nvcc gets
# them as defines, from which K1's code (csrc/ldpc_lifted_bp.cuh), K3's
# (csrc/ldpc_layered_bp.cuh) and their shared check-node code
# csrc/ldpc_cn.cuh take their constants. The row degrees the check-node
# code has a case for (it checks its cases against them): those of the
# 5G base graphs' rows, 3-10 and 19, and 1-2.
CN_ROW_DEGREES = frozenset(range(1, 11)) | {19}
# K1: threads per block, blocks per cluster, register-edge CN units per
# thread in one block and in a cluster (whose slot addresses take more
# registers).
K1_MAX_THREADS = 512
K1_MAX_CLUSTER = 8
K1_REG_UNITS = {False: 12, True: 8}  # by cluster layout
#: The arrays of K1's plan, in order; the plan starts with their offsets.
K1_PLAN_ARRAYS = ("row_ptr", "row_slot", "row_range", "col_ptr",
                  "col_slot", "col_shift", "reg_rows", "reg_pos", "reg_col",
                  "reg_shift", "plain_rows", "vn_cols")
# K3: threads per block (its launch bound), the threads the layout aims
# at per SM over the blocks the SM holds (one per lane fastest at the
# n=2048 code: PERF.md, Findings), and blocks per cluster (the portable
# most: BG1 at Z=384 and rate 1/3 takes 5 in f32).
K3_MAX_THREADS = 576
K3_SM_THREADS = 576
K3_MAX_CLUSTER = 8
#: The arrays of K3's plan, in order; the plan starts with their offsets,
#: and every array with a multiple of 4 ints (K3 reads "edge" as int4).
K3_PLAN_ARRAYS = ("edge", "step_ptr", "row_ptr")
_CN_DEFINES = {"SIONNA_CN_ROW_DEGREE_MASK":
               sum(1 << d for d in CN_ROW_DEGREES)}
# nvcc's defines of K1's and K3's code (csrc/ldpc_lifted_bp.cuh and
# csrc/ldpc_layered_bp.cuh), which the gradient's tape kernels run too
_K1_DEFINES = {"SIONNA_K1_MAX_THREADS": K1_MAX_THREADS,
               "SIONNA_K1_MAX_CLUSTER": K1_MAX_CLUSTER,
               "SIONNA_K1_REG_UNITS": K1_REG_UNITS[False],
               "SIONNA_K1_REG_UNITS_CLUSTER": K1_REG_UNITS[True],
               "SIONNA_K1_PLAN_ARRAYS": len(K1_PLAN_ARRAYS),
               **_CN_DEFINES}
_K3_DEFINES = {"SIONNA_K3_MAX_THREADS": K3_MAX_THREADS,
               "SIONNA_K3_MAX_CLUSTER": K3_MAX_CLUSTER,
               "SIONNA_K3_PLAN_ARRAYS": len(K3_PLAN_ARRAYS),
               **_CN_DEFINES}

#: The CUDA kernel of the lifted BP decoder (built on first use).
LIFTED_BP_KERNEL = CudaKernel(
    name="ldpc_lifted_bp",
    source="ldpc_lifted_bp.cu",
    replaces="sionna_tpu/phy/fec/ldpc/decoding.py:1106",
    functions={
        "sionna_ldpc_lifted_bp": ([_P] * 3 + [_I] * 9 + [_F, _F]
                                  + [_I] * 5 + [_P], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    defines=_K1_DEFINES)

#: The CUDA kernel of the layered lifted BP decoder (built on first use).
LAYERED_BP_KERNEL = CudaKernel(
    name="ldpc_layered_bp",
    source="ldpc_layered_bp.cu",
    replaces="sionna_tpu/phy/fec/ldpc/decoding.py:1203",
    functions={
        "sionna_ldpc_layered_bp": ([_P] * 3 + [_I] * 9 + [_F, _F]
                                   + [_I] * 4 + [_P], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    defines=_K3_DEFINES)


# ----------------------------------------------------------------------
# Edge-domain update functions.
#
# All cn_update_* functions have the signature
#   (v2c [..., E], cn_idx [E], num_cns, llr_clipping) -> c2v [..., E]
# and work in the classic log(P0/P1) convention. ``sorted_`` is the JAX
# package's hint that cn_idx is sorted; the torch reductions do not need
# it.
# ----------------------------------------------------------------------

def _segment_sum(x, idx, num_segments):
    """Sums x [..., E] over the edges of each segment (idx [E]) ->
    [..., num_segments]."""
    return x.new_zeros(x.shape[:-1] + (num_segments,)).index_add(
        -1, idx, x)


def _segment_min(x, idx, num_segments):
    """Minimum of x [..., E] over each segment; an empty segment reads
    +inf, as ``jax.ops.segment_min``'s does."""
    out = torch.full(x.shape[:-1] + (num_segments,), float("inf"),
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce(-1, idx.expand(x.shape), x, reduce="amin",
                              include_self=False)


def _take(x, idx):
    return x.index_select(-1, idx)


def _clip(x, llr_clipping):
    if llr_clipping is None:
        return x
    return torch.clamp(x, -llr_clipping, llr_clipping)


def _sign_product(v2c, cn_idx, num_cns):
    """Extrinsic sign per edge: the product of the signs of the other
    edges of its check node, from the parity of the count of negative
    inputs (integers, as the JAX package counts)."""
    neg = (v2c < 0).to(torch.int32)
    ext_neg = _take(_segment_sum(neg, cn_idx, num_cns), cn_idx) - neg
    return 1.0 - 2.0 * (ext_neg % 2).to(v2c.dtype)


def _two_min(mag, cn_idx, num_cns):
    """Per-edge extrinsic minimum of |v2c| over the other edges of the
    same check node: the second distinct minimum for the unique
    minimizer, the minimum otherwise (ties keep it)."""
    big = torch.finfo(mag.dtype).max
    m1_e = _take(_segment_min(mag, cn_idx, num_cns), cn_idx)
    is_min = mag == m1_e
    masked = torch.where(is_min, big, mag)
    m2_e = _take(_segment_min(masked, cn_idx, num_cns), cn_idx)
    cnt_e = _take(_segment_sum(is_min.to(torch.int32), cn_idx, num_cns),
                  cn_idx)
    return torch.where(is_min & (cnt_e == 1), m2_e, m1_e)


def cn_update_minsum(v2c, cn_idx, num_cns, llr_clipping=None,
                     sorted_=True):
    """Min-sum check node update."""
    ext = _two_min(torch.abs(v2c), cn_idx, num_cns)
    return _clip(_sign_product(v2c, cn_idx, num_cns) * ext, llr_clipping)


def cn_update_offset_minsum(v2c, cn_idx, num_cns, llr_clipping=None,
                            offset=0.5, sorted_=True):
    """Offset-corrected min-sum check node update."""
    ext = _two_min(torch.abs(v2c), cn_idx, num_cns)
    ext = torch.clamp(ext - offset, min=0.0)
    return _clip(_sign_product(v2c, cn_idx, num_cns) * ext, llr_clipping)


def cn_update_tanh(v2c, cn_idx, num_cns, llr_clipping=None, sorted_=True):
    """Exact boxplus through the tanh rule, as sums of log|tanh(x/2)|
    (floored at 1e-12), the extrinsic product clamped below 1."""
    sign = _sign_product(v2c, cn_idx, num_cns)
    eps = torch.tensor(1e-12, dtype=v2c.dtype, device=v2c.device)
    logtanh = torch.log(torch.maximum(torch.tanh(torch.abs(v2c) / 2), eps))
    ext = _take(_segment_sum(logtanh, cn_idx, num_cns), cn_idx) - logtanh
    e = torch.clamp(torch.exp(ext), max=1 - 1e-7)
    return _clip(sign * 2 * torch.atanh(e), llr_clipping)


def _phi(x):
    """phi(x) = -log(tanh(x/2)), self-inverse on x > 0."""
    x = torch.clamp(x, 8.5e-8, 16.635532)
    return -torch.log(torch.tanh(x / 2))


def cn_update_phi(v2c, cn_idx, num_cns, llr_clipping=None, sorted_=True):
    """Boxplus through sums of phi(|v2c|)."""
    sign = _sign_product(v2c, cn_idx, num_cns)
    ph = _phi(torch.abs(v2c))
    ext = _take(_segment_sum(ph, cn_idx, num_cns), cn_idx) - ph
    return _clip(sign * _phi(ext), llr_clipping)


def _marginals(c2v, llr_ch, vn_idx, num_vns):
    """Channel LLR plus the sum of the incoming messages of each
    variable node, the messages added to the LLR in edge order: what
    XLA computes for ``segment_sum(c2v) + llr_ch`` once it folds the
    add into the scatter (it does inside every jitted decoder loop)."""
    dtype = torch.result_type(c2v, llr_ch)
    base = llr_ch.to(dtype).expand(c2v.shape[:-1] + (num_vns,))
    return base.index_add(-1, vn_idx, c2v.to(dtype))


def vn_update_sum(c2v, llr_ch, vn_idx, num_vns, llr_clipping=None):
    """Variable node update: marginal = channel LLR + the sum of the
    incoming messages; v2c = marginal minus the edge's own message.
    Returns (v2c, marginals)."""
    marg = _marginals(c2v, llr_ch, vn_idx, num_vns)
    v2c = _take(marg, vn_idx) - c2v
    return _clip(v2c, llr_clipping), _clip(marg, llr_clipping)


def cn_node_update_identity(v2c, cn_idx, num_cns, llr_clipping=None,
                            sorted_=True):
    """Identity check node update, for testing message passing:
    c2v = v2c."""
    return _clip(v2c, llr_clipping)


def vn_node_update_identity(c2v, llr_ch, vn_idx, num_vns,
                            llr_clipping=None):
    """Identity variable node update, for testing: passes the messages
    through and returns the marginals as second output."""
    marg = _marginals(c2v, llr_ch, vn_idx, num_vns)
    return _clip(c2v, llr_clipping), _clip(marg, llr_clipping)


_CN_UPDATES = {
    "minsum": cn_update_minsum,
    "offset-minsum": cn_update_offset_minsum,
    "boxplus": cn_update_tanh,
    "boxplus-phi": cn_update_phi,
    "identity": cn_node_update_identity,
}


class LDPCBPDecoder(Block):
    """Belief-propagation decoder for arbitrary parity-check matrices.

    Input llr_ch [..., n] in the logit convention log(P(b=1)/P(b=0));
    output soft LLRs (same convention) or hard bits of shape [..., n],
    and with ``return_state`` also the last v2c messages [batch, E]
    (logit convention), which ``msg_v2c`` takes back as a warm start of
    the flooding schedule.

    ``cn_update`` is "boxplus-phi", "boxplus", "minsum",
    "offset-minsum", "identity" or a callable with the ``cn_update_*``
    signature; ``vn_update`` "sum", "identity" or a callable.
    ``cn_schedule`` is "flooding", "layered" (one check node per layer)
    or a list of check-node index arrays, one per layer. Callbacks
    ``cb(msg, it) -> msg`` run on the v2c messages before and on the c2v
    messages after each flooding check-node update.
    ``internal_precision="bf16"`` keeps the flooding messages in bf16.
    ``engine="matmul"`` computes the built-in flooding updates with
    one-hot incidence products (when E * max(C, V) <= 64e6); callables,
    callbacks and larger codes use the segment engine.
    """

    def __init__(self, pcm, cn_update="boxplus-phi", vn_update="sum",
                 cn_schedule="flooding", hard_out=True, num_iter=20,
                 llr_max=20., v2c_callbacks=None, c2v_callbacks=None,
                 return_state=False, internal_precision=None,
                 engine="segment", precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if internal_precision not in (None, "bf16"):
            raise ValueError("internal_precision must be None or 'bf16'")
        self._internal_precision = internal_precision
        if engine not in ("segment", "matmul"):
            raise ValueError("engine must be 'segment' or 'matmul'")
        self._engine = engine
        if isinstance(pcm, np.ndarray):
            pcm = sp_sparse.csr_matrix(pcm)
        elif not sp_sparse.issparse(pcm):
            raise TypeError("Unsupported dtype of pcm.")
        pcm = pcm.tocsr()
        if not np.all(np.isin(pcm.data, [0, 1])):
            raise ValueError("PC matrix must be binary.")
        self._pcm = pcm
        self._num_cns, self._num_vns = pcm.shape

        coo = pcm.tocoo()
        order = np.lexsort((coo.col, coo.row))  # row-major edge order
        self._cn_idx = coo.row[order].astype(np.int64)
        self._vn_idx = coo.col[order].astype(np.int64)
        self._num_edges = len(coo.row)

        if not isinstance(hard_out, bool):
            raise TypeError("hard_out must be bool.")
        if not isinstance(num_iter, int) or num_iter < 0:
            raise ValueError("num_iter must be a nonnegative int.")
        self._hard_out = hard_out
        self._num_iter = num_iter
        self._llr_max = float(llr_max)
        self._return_state = bool(return_state)

        if callable(cn_update):
            self._cn_update = cn_update
        elif cn_update in _CN_UPDATES:
            self._cn_update = _CN_UPDATES[cn_update]
        else:
            raise ValueError(f"Unknown cn_update: {cn_update}")
        if callable(vn_update):
            self._vn_update_fn = vn_update
        elif vn_update == "sum":
            self._vn_update_fn = vn_update_sum
        elif vn_update == "identity":
            self._vn_update_fn = vn_node_update_identity
        else:
            raise ValueError(f"Unknown vn_update: {vn_update}")
        self._cn_update_name = cn_update if isinstance(cn_update, str) \
            else None

        if isinstance(cn_schedule, str) and cn_schedule == "flooding":
            self._scheduling = "flooding"
            self._layers = None
        elif isinstance(cn_schedule, str) and cn_schedule == "layered":
            self._scheduling = "layered"
            self._layers = [np.array([c]) for c in range(pcm.shape[0])]
        elif isinstance(cn_schedule, (list, tuple, np.ndarray)):
            self._scheduling = "layered"
            self._layers = [np.asarray(l).reshape(-1) for l in cn_schedule]
        else:
            raise ValueError(
                "cn_schedule must be 'flooding', 'layered', or a "
                "list of CN-index arrays")

        self._v2c_callbacks = list(v2c_callbacks or [])
        self._c2v_callbacks = list(c2v_callbacks or [])
        # callbacks that are modules (trainable weights) follow .to()
        # and show up in parameters()
        self.callback_modules = nn.ModuleList(
            cb for cb in self._v2c_callbacks + self._c2v_callbacks
            if isinstance(cb, nn.Module))

        self._buf("cn_idx", self._cn_idx)
        self._buf("vn_idx", self._vn_idx)
        if self._layers is not None:
            self._build_layered_layout()
        # One-hot incidence matrices [E, C] / [E, V] for the matmul
        # engine: exact for the sums and per-edge broadcasts (counts
        # are bounded by the node degrees)
        self._use_matmul_engine = (
            engine == "matmul"
            and self._num_edges * max(self._num_cns, self._num_vns)
            <= 64_000_000)
        if self._use_matmul_engine:
            e = np.arange(self._num_edges)
            m_inc = np.zeros((self._num_edges, self._num_cns), np.float32)
            m_inc[e, self._cn_idx] = 1.
            n_inc = np.zeros((self._num_edges, self._num_vns), np.float32)
            n_inc[e, self._vn_idx] = 1.
            self._buf("m_inc", m_inc, torch.float32)
            self._buf("n_inc", n_inc, torch.float32)

    def _buf(self, name, value, dtype=torch.int64):
        self.register_buffer(name, torch.as_tensor(
            np.asarray(value), dtype=dtype, device=self.device),
            persistent=False)

    def _build_layered_layout(self):
        """Padded per-layer edge tables of the layered (serial-C)
        schedule: for each layer, the edge ids of its check nodes
        (padded to the largest layer with a dummy edge E), the
        layer-local check node of each edge (padded with a dummy check
        node) and its variable node (padded with a dummy node V)."""
        cn_to_edges = {}
        for e, c in enumerate(self._cn_idx):
            cn_to_edges.setdefault(int(c), []).append(e)
        num_layers = len(self._layers)
        max_cns = max(len(l) for l in self._layers)
        max_edges = max(sum(len(cn_to_edges.get(int(c), [])) for c in l)
                        for l in self._layers)
        edge_ids = np.full((num_layers, max_edges), self._num_edges)
        cn_local = np.full((num_layers, max_edges), max_cns)
        vn_of_edge = np.full((num_layers, max_edges), self._num_vns)
        for li, layer in enumerate(self._layers):
            p = 0
            for local_c, c in enumerate(layer):
                for e in cn_to_edges.get(int(c), []):
                    edge_ids[li, p] = e
                    cn_local[li, p] = local_c
                    vn_of_edge[li, p] = self._vn_idx[e]
                    p += 1
        self._buf("layer_edge_ids", edge_ids)
        self._buf("layer_cn_local", cn_local)
        self._buf("layer_vn", vn_of_edge)
        self._layer_num_cns = max_cns + 1  # + dummy

    def _decode_layered(self, llr_int, num_iter):
        """Layered (serial-C) decoding: the marginals take each layer's
        new check messages at once. State: marginals [B, V + 1] and c2v
        [B, E + 1], one dummy column each for the padding (the dummy
        edge's c2v is overwritten by every padded slot, and neither
        dummy reaches a real node). Returns marginals [B, V]."""
        batch = llr_int.shape[0]
        marg = torch.cat([llr_int, llr_int.new_zeros(batch, 1)], dim=1)
        c2v = llr_int.new_zeros(batch, self._num_edges + 1)
        for _ in range(num_iter):
            for eids, cn_loc, vns in zip(self.layer_edge_ids,
                                         self.layer_cn_local,
                                         self.layer_vn):
                c2v_old = c2v[:, eids]
                v2c = marg[:, vns] - c2v_old
                c2v_new = self._cn_update(v2c, cn_loc, self._layer_num_cns,
                                          llr_clipping=self._llr_max)
                marg = marg.index_add(1, vns, c2v_new - c2v_old)
                c2v = c2v.index_copy(1, eids, c2v_new)
        return marg[:, :self._num_vns]

    # ------------------------------------------------------------------
    # Incidence-matmul update engine
    # ------------------------------------------------------------------
    def _cn_update_matmul(self, v2c):
        """Check-node update on [B, E] messages with the graph sums and
        per-edge broadcasts as one-hot incidence products; only the
        extrinsic min and second min stay segment reductions. As in the
        JAX package, its min-sum tests minima with <=, its boxplus
        clamps |v2c| at the clipping value before the log, and every
        other name (including "identity") takes the boxplus-phi
        branch."""
        name = self._cn_update_name
        m_inc = self.m_inc.to(v2c.dtype)  # [E, C]
        clip = self._llr_max
        big = torch.finfo(v2c.dtype).max

        # extrinsic sign from the parity of negative-message counts
        neg = (v2c < 0).to(v2c.dtype)
        ext_neg = (neg @ m_inc) @ m_inc.T - neg
        sign = 1. - 2. * torch.remainder(ext_neg, 2)

        if name in ("minsum", "offset-minsum"):
            mag = torch.abs(v2c)
            m1_e = _segment_min(mag, self.cn_idx, self._num_cns) @ m_inc.T
            is_min = mag <= m1_e
            cnt_e = (is_min.to(v2c.dtype) @ m_inc) @ m_inc.T
            masked = torch.where(is_min, big, mag)
            m2_e = _segment_min(masked, self.cn_idx,
                                self._num_cns) @ m_inc.T
            ext = torch.where(is_min & (cnt_e < 1.5), m2_e, m1_e)
            if name == "offset-minsum":
                ext = torch.clamp(ext - 0.5, min=0.)
        elif name == "boxplus":
            mag = torch.clamp(torch.clamp(torch.abs(v2c), min=1e-12),
                              max=clip)
            lt = torch.log(torch.tanh(mag / 2.))
            ext_lt = (lt @ m_inc) @ m_inc.T - lt
            ext = 2. * torch.atanh(torch.clamp(torch.exp(ext_lt), 0.,
                                               1. - 1e-7))
        else:  # boxplus-phi
            mag = torch.clamp(torch.abs(v2c), 8.5e-8, 16.635532)
            phi = -torch.log(torch.tanh(mag / 2.))
            ext_phi = torch.clamp((phi @ m_inc) @ m_inc.T - phi,
                                  min=8.5e-8)
            ext = -torch.log(torch.tanh(ext_phi / 2.))
        return torch.clamp(sign * ext, -clip, clip)

    def _vn_update_matmul(self, c2v, llr_int):
        """Variable-node update as two incidence products; the
        marginals are not clipped."""
        n_inc = self.n_inc.to(c2v.dtype)  # [E, V]
        marg = llr_int + c2v @ n_inc
        v2c = marg @ n_inc.T - c2v
        return torch.clamp(v2c, -self._llr_max, self._llr_max), marg

    # ------------------------------------------------------------------
    @property
    def pcm(self):
        return self._pcm

    @property
    def num_cns(self):
        return self._num_cns

    @property
    def num_vns(self):
        return self._num_vns

    @property
    def n(self):
        return self._num_vns

    @property
    def coderate(self):
        return (self._num_vns - self._num_cns) / self._num_vns

    @property
    def num_edges(self):
        return self._num_edges

    @property
    def num_iter(self):
        return self._num_iter

    @num_iter.setter
    def num_iter(self, v):
        self._num_iter = int(v)

    @property
    def llr_max(self):
        return self._llr_max

    @llr_max.setter
    def llr_max(self, value):
        self._llr_max = float(value)

    @property
    def return_state(self):
        return self._return_state

    # ------------------------------------------------------------------
    def _iterations(self, num_iter):
        n_it = self._num_iter if num_iter is None else num_iter
        if not isinstance(n_it, int) or n_it < 0:
            raise ValueError("num_iter must be a nonnegative int.")
        return n_it

    def forward(self, llr_ch, num_iter=None, msg_v2c=None):
        if llr_ch.device != self.device:
            raise ValueError(
                f"LLRs are on {llr_ch.device} but the decoder's tables "
                f"are on {self.device}; move one with .to()")
        in_shape = llr_ch.shape
        llr = llr_ch.reshape(-1, self._num_vns)
        batch = llr.shape[0]
        num_iter = self._iterations(num_iter)

        # internal classic convention log(P0/P1)
        llr_int = -torch.clamp(llr, -self._llr_max, self._llr_max)
        if msg_v2c is None:
            v2c0 = _take(llr_int, self.vn_idx)
        else:
            v2c0 = -msg_v2c.reshape(batch, self._num_edges)

        if self._scheduling == "layered":
            marg = self._decode_layered(llr_int, num_iter)
            v2c = torch.zeros_like(v2c0)
        else:
            mdtype = torch.bfloat16 if self._internal_precision == "bf16" \
                else self.rdtype
            llr_m = llr_int.to(mdtype)
            v2c, marg = v2c0.to(mdtype), llr_m
            # the matmul engine covers the built-in updates without
            # callbacks; everything else runs on the segment engine
            if (self._use_matmul_engine
                    and self._cn_update_name in _CN_UPDATES
                    and self._vn_update_fn is vn_update_sum
                    and not self._v2c_callbacks
                    and not self._c2v_callbacks):
                for _ in range(num_iter):
                    v2c, marg = self._vn_update_matmul(
                        self._cn_update_matmul(v2c), llr_m)
            else:
                for it in range(num_iter):
                    for cb in self._v2c_callbacks:
                        v2c = cb(v2c, it)
                    c2v = self._cn_update(v2c, self.cn_idx, self._num_cns,
                                          llr_clipping=self._llr_max)
                    for cb in self._c2v_callbacks:
                        c2v = cb(c2v, it)
                    v2c, marg = self._vn_update_fn(
                        c2v, llr_m, self.vn_idx, self._num_vns,
                        llr_clipping=self._llr_max)
            v2c, marg = v2c.to(self.rdtype), marg.to(self.rdtype)

        # back to the logit convention
        llr_out = -marg
        out = (llr_out > 0).to(self.rdtype) if self._hard_out else llr_out
        out = out.reshape(in_shape)
        if self._return_state:
            return out, -v2c
        return out


class LDPC5GDecoder(LDPCBPDecoder):
    """5G NR LDPC decoder with rate recovery for an associated
    :class:`LDPC5GEncoder`.

    With ``prune_pcm`` the degree-1 parity nodes that are never
    transmitted are removed from the graph. ``engine="auto"`` takes the
    lifted engine for the built-in check-node updates ("boxplus" and
    "boxplus-phi" both the exact tanh rule there, "minsum",
    "offset-minsum" with offset 0.5) with the flooding schedule, no
    callbacks and no ``return_state``, and the segment engine of
    :class:`LDPCBPDecoder` otherwise, the layered schedule (one layer
    per lifted base row) included. ``engine="lifted"`` and "pallas"
    (the same engine here) take the lifted engine for the flooding and
    the layered schedule: the plain torch decode for CPU tensors, the
    CUDA kernel for CUDA tensors. "segment" and "matmul" select those
    engines of :class:`LDPCBPDecoder`.
    """

    def __init__(self, encoder, cn_update="boxplus-phi", vn_update="sum",
                 cn_schedule="flooding", hard_out=True,
                 return_infobits=True, num_iter=20, llr_max=20.,
                 v2c_callbacks=None, c2v_callbacks=None, prune_pcm=True,
                 return_state=False, internal_precision=None,
                 engine="auto", precision=None, device=None):
        if not isinstance(encoder, LDPC5GEncoder):
            raise TypeError("encoder must be of class LDPC5GEncoder.")
        pcm = encoder.pcm
        if prune_pcm:
            # prune the degree-1 parity VNs that are never transmitted
            dv = np.asarray(pcm.sum(axis=0)).ravel()
            last_pos = encoder.n_ldpc
            for idx in range(encoder.n_ldpc - 1, 0, -1):
                if dv[idx] == 1:
                    last_pos = idx
                else:
                    break
            k_filler = encoder.k_ldpc - encoder.k
            nb_punc_bits = (encoder.n_ldpc - k_filler) - encoder.n \
                - 2 * encoder.z
            n_pruned = int(max(last_pos, encoder.n_ldpc - nb_punc_bits))
            nb_pruned_nodes = encoder.n_ldpc - n_pruned
            if nb_pruned_nodes > 0:
                pcm = pcm[:-nb_pruned_nodes, :-nb_pruned_nodes]
        else:
            nb_pruned_nodes = 0
            n_pruned = encoder.n_ldpc

        is_layered_str = (isinstance(cn_schedule, str)
                          and cn_schedule == "layered")
        if is_layered_str:
            # one layer per lifted base row (Z check nodes each)
            z, num_cns = encoder.z, pcm.shape[0]
            cn_schedule = [np.arange(i, min(i + z, num_cns))
                           for i in range(0, num_cns, z)]
        is_flooding = isinstance(cn_schedule, str) \
            and cn_schedule == "flooding"
        builtin_cn = isinstance(cn_update, str) \
            and cn_update in _LIFTED_CN_UPDATES
        if engine == "auto":
            engine = "lifted" if (
                builtin_cn and is_flooding and not return_state
                and not (v2c_callbacks or c2v_callbacks)) else "segment"
        use_lifted = engine in ("lifted", "pallas")
        if use_lifted:
            if not builtin_cn or not (is_flooding or is_layered_str):
                raise ValueError(
                    "engine='lifted'/'pallas' supports the built-in CN "
                    "updates ('minsum', 'offset-minsum', 'boxplus', "
                    "'boxplus-phi') with the flooding or layered schedule")
            if return_state:
                raise ValueError(
                    "engine='lifted'/'pallas' does not keep per-edge "
                    "message state; use engine='segment' (or "
                    "engine='auto', which falls back automatically) "
                    "when return_state=True")
            engine = "segment"  # the base class's engine, unused

        super().__init__(pcm, cn_update=cn_update, vn_update=vn_update,
                         cn_schedule=cn_schedule, hard_out=hard_out,
                         num_iter=num_iter, llr_max=llr_max,
                         v2c_callbacks=v2c_callbacks,
                         c2v_callbacks=c2v_callbacks,
                         return_state=return_state,
                         internal_precision=internal_precision,
                         engine=engine, precision=precision, device=device)
        if encoder.device != self.device:
            raise ValueError(f"the encoder is on {encoder.device}, the "
                             f"decoder on {self.device}")
        self.encoder = encoder
        self._return_infobits = bool(return_infobits)
        self._prune_pcm = bool(prune_pcm)
        self._nb_pruned_nodes = nb_pruned_nodes
        self._n_pruned = n_pruned
        self._lifted_layered = use_lifted and is_layered_str
        self.lifted = LDPC5GLiftedBP(
            encoder, self._num_cns, self._num_vns, self._llr_max,
            offset=0.5 if cn_update == "offset-minsum" else 0.0,
            cn_mode="boxplus" if cn_update in ("boxplus", "boxplus-phi")
            else "minsum", device=self.device) if use_lifted else None

    def _llr_5g(self, llr_ch):
        """Rate recovery: channel LLRs [..., n] (logit convention) ->
        LLRs of the pruned mother code [B, n_pruned], same convention.

        Undoes the output interleaver, restores the 2Z punctured and the
        unsent parity positions as zeros (unknown) and sets the filler
        bits to a strongly known zero."""
        llr_ch = torch.as_tensor(llr_ch).to(self.rdtype)
        if llr_ch.device != self.device:
            raise ValueError(
                f"LLRs are on {llr_ch.device} but the decoder's tables "
                f"are on {self.device}; move one with .to()")
        enc = self.encoder
        llr = llr_ch.reshape(-1, enc.n)
        batch = llr.shape[0]
        dev, dt = llr.device, self.rdtype

        if enc.out_int_inv is not None:
            llr = llr[:, enc.out_int_inv]

        # undo puncturing of the first 2Z bits (zero LLR = unknown)
        k_filler = enc.k_ldpc - enc.k
        nb_punc_bits = (enc.n_ldpc - k_filler) - enc.n - 2 * enc.z
        llr_5g = torch.cat(
            [torch.zeros((batch, 2 * enc.z), dtype=dt, device=dev), llr,
             torch.zeros((batch, nb_punc_bits - self._nb_pruned_nodes),
                         dtype=dt, device=dev)], dim=1)
        # filler bits are known zeros: strongly negative logit
        nb_par_bits = enc.n_ldpc - k_filler - enc.k - self._nb_pruned_nodes
        return torch.cat(
            [llr_5g[:, :enc.k],
             torch.full((batch, k_filler), -self._llr_max, dtype=dt,
                        device=dev),
             llr_5g[:, enc.k:enc.k + nb_par_bits]], dim=1)

    def recover_llrs(self, llr_ch):
        """Rate recovery into the lifted engine's input: channel LLRs
        [..., n] (logit convention) -> classic-convention LLRs
        [B, num_vns], clipped to ``llr_max``."""
        return -torch.clamp(self._llr_5g(llr_ch), -self._llr_max,
                            self._llr_max)

    def forward(self, llr_ch, num_iter=None, msg_v2c=None):
        in_shape = llr_ch.shape
        enc = self.encoder
        if self.lifted is not None:
            if msg_v2c is not None:
                raise ValueError(
                    "engine='lifted'/'pallas' cannot warm-start from "
                    "msg_v2c; use engine='segment' for state "
                    "round-tripping")
            n_it = self._iterations(num_iter)
            llr_out = -self.lifted(self.recover_llrs(llr_ch), n_it,
                                   layered=self._lifted_layered)
            x_hat = (llr_out > 0).to(self.rdtype) if self._hard_out \
                else llr_out
        else:
            output = super().forward(self._llr_5g(llr_ch),
                                     num_iter=num_iter, msg_v2c=msg_v2c)
            x_hat, state = output if self._return_state else (output, None)

        if self._return_infobits:
            out = x_hat[:, :enc.k].reshape(tuple(in_shape[:-1]) + (enc.k,))
        else:
            x_no_filler = torch.cat([x_hat[:, :enc.k],
                                     x_hat[:, enc.k_ldpc:]], dim=1)
            x_short = x_no_filler[:, 2 * enc.z:2 * enc.z + enc.n]
            if enc.out_int is not None:
                x_short = x_short[:, enc.out_int]
            out = x_short.reshape(in_shape)
        if self._return_state:
            return out, state
        return out


def _lifted_cn_phase(v2c, masks, row_edges, n_edges, clip, offset, mode,
                     full, atanh_form="log1p"):
    """CN phase of the plain lifted engine, op for op as the JAX
    package's ``_lifted_cn_phase``.

    ``v2c``: list of [B, Z] CN-aligned messages; ``masks``: list of [Z]
    activity masks; ``full[e]`` marks edges whose mask is all ones (their
    mask selects are skipped). ``mode="minsum"``: two-minima tracking
    with optional offset. ``mode="boxplus"``: tanh rule with prefix and
    suffix products, extrinsic clamped at 1 - 1e-7, magnitude
    log1p(x) - log1p(-x), or log((1 + x) / (1 - x)) with
    ``atanh_form="ratio"``."""
    ref = next(v for v in v2c if v is not None)
    c2v = [None] * n_edges
    big = torch.tensor(1e30, dtype=ref.dtype, device=ref.device)
    one = torch.tensor(1., dtype=ref.dtype, device=ref.device)
    hi = torch.tensor(1 - 1e-7, dtype=ref.dtype, device=ref.device)
    for eids in row_edges.values():
        if mode == "boxplus":
            d = len(eids)
            mags, signs = [], []
            for e in eids:
                m = v2c[e]
                t = torch.tanh(torch.abs(m) / 2)
                sgn = torch.where(m < 0, -one, one)
                if not full[e]:
                    act = masks[e] > 0
                    t = torch.where(act, t, one)
                    sgn = torch.where(act, sgn, one)
                mags.append(t)
                signs.append(sgn)
            fwd = [mags[0]]
            for t in mags[1:]:
                fwd.append(fwd[-1] * t)
            bwd = [mags[-1]]
            for t in mags[-2::-1]:
                bwd.append(bwd[-1] * t)
            bwd = bwd[::-1]
            sign_tot = signs[0]
            for sgn in signs[1:]:
                sign_tot = sign_tot * sgn
            for i, (e, sgn) in enumerate(zip(eids, signs)):
                if d == 1:
                    ext = hi
                elif i == 0:
                    ext = torch.minimum(bwd[1], hi)
                elif i == d - 1:
                    ext = torch.minimum(fwd[d - 2], hi)
                else:
                    ext = torch.minimum(fwd[i - 1] * bwd[i + 1], hi)
                if atanh_form == "ratio":
                    mag = torch.log((1. + ext) / (1. - ext))
                else:
                    mag = torch.log1p(ext) - torch.log1p(-ext)
                out = sign_tot * sgn * torch.clamp(mag, max=clip)
                c2v[e] = out if full[e] else out * masks[e]
            continue
        mags, signs = [], []
        for e in eids:
            m = v2c[e]
            a = torch.abs(m)
            sgn = torch.where(m < 0, -one, one)
            if not full[e]:
                act = masks[e] > 0
                a = torch.where(act, a, big)
                sgn = torch.where(act, sgn, one)
            mags.append(a)
            signs.append(sgn)
        min1 = mags[0]
        for m in mags[1:]:
            min1 = torch.minimum(min1, m)
        min2 = big
        for m in mags:
            min2 = torch.minimum(min2, torch.where(m > min1, m, big))
        n_min = sum((m == min1).to(m.dtype) for m in mags)
        sign_tot = signs[0]
        for sgn in signs[1:]:
            sign_tot = sign_tot * sgn
        for e, m, sgn in zip(eids, mags, signs):
            unique_min = (m == min1) & (n_min == 1)
            ext = torch.where(unique_min, min2, min1)
            if offset > 0.:
                ext = torch.clamp(ext - offset, min=0.)
            out = sign_tot * sgn * torch.clamp(ext, max=clip)
            c2v[e] = out if full[e] else out * masks[e]
    return c2v


def _check_knobs(storage_dtype, atanh_form):
    """The Pallas kernel's two knobs: message storage None (the LLRs'
    dtype) or torch.bfloat16; boxplus magnitude "log1p" or "ratio"."""
    if storage_dtype is not None and storage_dtype != torch.bfloat16:
        raise ValueError("storage_dtype must be None or torch.bfloat16, "
                         f"got {storage_dtype}")
    if atanh_form not in ("log1p", "ratio"):
        raise ValueError("atanh_form must be 'log1p' or 'ratio', got "
                         f"{atanh_form!r}")


def _stored(storage_dtype):
    """What a store into the message state does to a value: nothing, or
    rounding to bf16 (nearest even) and widening back."""
    if storage_dtype is None:
        return lambda x: x
    return lambda x: x.to(storage_dtype).to(x.dtype)


def _csr(groups, n_groups):
    """(ptr [n_groups + 1], ids) of a dict group -> list of edge ids."""
    ptr, ids = [0], []
    for g in range(n_groups):
        ids += groups.get(g, [])
        ptr.append(len(ids))
    return ptr, ids


class LDPC5GLiftedBP(nn.Module):
    """Lifted block-circulant BP engine for 5G LDPC codes
    ((offset-)min-sum and exact-SPA boxplus CN updates).

    Messages live per base edge as [batch, Z] blocks in check-node
    alignment; a cyclic shift is a roll by the base entry mod Z. The
    edge tables are built once here and kept as buffers, so ``.to()``
    moves them to the device the kernel reads them on.

    Calling the module (the counterpart of ``_lifted_pallas_decode``)
    decodes with the plain torch version on a CPU tensor and with the
    CUDA kernel of the schedule on a CUDA tensor. It takes the Pallas
    kernel's knobs: ``storage_dtype=torch.bfloat16`` keeps the message
    state in bf16 (v2c in flooding, c2v in layered; all arithmetic in
    f32), ``atanh_form="ratio"`` computes the boxplus magnitude as
    log((1 + x) / (1 - x)) in flooding; the layered schedule ignores
    ``atanh_form``, as the Pallas kernel's does.
    """

    def __init__(self, encoder, num_cns, num_vns, llr_max, offset=0.0,
                 cn_mode="minsum", device=None):
        super().__init__()
        if cn_mode not in ("minsum", "boxplus"):
            raise ValueError("cn_mode must be 'minsum' or 'boxplus'")
        self._z = z = int(encoder.z)
        self._llr_max = float(llr_max)
        self._offset = float(offset)
        self._cn_mode = cn_mode
        bm = np.asarray(encoder._bm)
        n_row_blocks = -(-num_cns // z)
        n_col_blocks = -(-num_vns // z)
        self._n_row_blocks = n_row_blocks
        self._n_col_blocks = n_col_blocks
        self._num_vns = num_vns

        # Active base edges within the pruned window
        edges = []
        for r in range(n_row_blocks):
            for c in range(n_col_blocks):
                s = int(bm[r, c])
                if s >= 0:
                    edges.append((r, c, s % z))
        self._edges = edges
        self._row_edges = {}
        self._col_edges = {}
        for e, (r, c, s) in enumerate(edges):
            self._row_edges.setdefault(r, []).append(e)
            self._col_edges.setdefault(c, []).append(e)

        # Per-edge activity mask in CN alignment:
        # active[i] = cn (r, i) exists AND vn (c, (i+s)%z) exists
        cn_act = np.zeros((n_row_blocks, z), np.float32)
        vn_act = np.zeros((n_col_blocks, z), np.float32)
        for r in range(n_row_blocks):
            cn_act[r, :max(min(num_cns - r * z, z), 0)] = 1.
        for c in range(n_col_blocks):
            vn_act[c, :max(min(num_vns - c * z, z), 0)] = 1.
        self._edge_mask = [cn_act[r] * np.roll(vn_act[c], -s)
                           for (r, c, s) in edges]
        self._edge_full = [bool(np.all(m == 1.)) for m in self._edge_mask]

        device = config.device if device is None else device

        def buf(name, values, dtype=torch.int32):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(values), dtype=dtype,
                                      device=device), persistent=False)

        row_ptr, row_ids = _csr(self._row_edges, n_row_blocks)
        col_ptr, col_ids = _csr(self._col_edges, n_col_blocks)
        buf("masks", np.stack(self._edge_mask), torch.float32)  # [E_b, Z]
        buf("row_ptr", row_ptr)
        buf("row_edge_ids", row_ids)
        buf("col_ptr", col_ptr)
        buf("col_edge_ids", col_ids)
        self._k1_layout = None
        self._k1_plans = {}  # K1's plan by device (k1_plan)
        self._k3_layouts = {}  # K3's layout by storage dtype (k3_layout)
        self._k3_plans = {}  # K3's plan by device (k3_plan)
        self._grad_plans = {}  # K5b/K5Lb layouts and plans (lifted_grad)

    def k1_layout(self):
        """:func:`lifted_bp_layout` of this code (cached)."""
        if self._k1_layout is None:
            self._k1_layout = lifted_bp_layout(self)
        return self._k1_layout

    def k1_plan(self, device):
        """The plan of :meth:`k1_layout` as an int32 tensor on ``device``
        (cached)."""
        device = torch.device(device)
        if device not in self._k1_plans:
            self._k1_plans[device] = torch.as_tensor(self.k1_layout().plan,
                                                     device=device)
        return self._k1_plans[device]

    def k3_layout(self, storage_dtype=None):
        """:func:`layered_bp_layout` of this code for c2v storage
        ``storage_dtype`` (cached)."""
        if storage_dtype not in self._k3_layouts:
            self._k3_layouts[storage_dtype] = layered_bp_layout(
                self, storage_dtype)
        return self._k3_layouts[storage_dtype]

    def k3_plan(self, device):
        """The plan of :meth:`k3_layout` (the same for both storage
        types) as an int32 tensor on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._k3_plans:
            self._k3_plans[device] = torch.as_tensor(
                _layered_bp_plan(self).plan, device=device)
        return self._k3_plans[device]

    def numpy_structure(self):
        """The lifted graph as NumPy arrays, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {"edges": np.asarray(self._edges, np.int64).reshape(-1, 3),
                "edge_mask": np.stack(self._edge_mask)}

    def forward(self, llr_int, num_iter, layered=False, storage_dtype=None,
                atanh_form="log1p"):
        """llr_int: [batch, num_vns] classic-convention LLRs. Returns
        marginals [batch, num_vns] after ``num_iter`` flooding or
        (``layered``) layered iterations.

        When the LLRs require grad (and grad mode is on), the decode runs
        through :class:`~.lifted_grad.LiftedBPFunction`: the tape kernel
        K5f (or K5Lf) and the backward kernel K5b (K5Lb) on a CUDA tensor,
        their plain versions on a CPU tensor. Under grad, bf16 storage and
        the ratio form raise: JAX differentiates only the XLA engine,
        which has neither."""
        _check_knobs(storage_dtype, atanh_form)
        if torch.is_grad_enabled() and llr_int.requires_grad:
            _check_grad_knobs(storage_dtype, atanh_form)
            from .lifted_grad import lifted_bp_grad
            return lifted_bp_grad(self, llr_int, num_iter, layered)
        if llr_int.is_cuda:
            if layered:
                return layered_bp_cuda(self, llr_int, num_iter,
                                       storage_dtype)
            return lifted_bp_cuda(self, llr_int, num_iter, storage_dtype,
                                  atanh_form)
        if llr_int.device.type != "cpu":
            raise ValueError(f"no lifted BP decoder for {llr_int.device}")
        if layered:
            return self.decode_layered(llr_int, num_iter, storage_dtype)
        return self.decode(llr_int, num_iter, storage_dtype, atanh_form)

    def decode(self, llr_int, num_iter, storage_dtype=None,
               atanh_form="log1p", tape=None):
        """Plain torch version of the lifted BP iteration (the flooding
        kernel's oracle). llr_int: [batch, num_vns] classic-convention
        LLRs. Returns marginals [batch, num_vns]. With bf16 storage the
        initial and every new v2c message is rounded to bf16 as the
        kernel stores it; c2v and the marginals are never rounded.
        ``tape`` ([num_iter, E, batch, Z], optional) receives the
        CN-aligned v2c messages each iteration reads (the gradient's
        tape, ``lifted_grad.flooding_tape_forward``)."""
        _check_knobs(storage_dtype, atanh_form)
        store = _stored(storage_dtype)
        z = self._z
        batch = llr_int.shape[0]
        clip = self._llr_max
        edges = self._edges
        col_edges = self._col_edges
        pad = self._n_col_blocks * z - self._num_vns
        # [B, C_b, z] variable-aligned channel LLRs
        llr_vn = F.pad(llr_int, (0, pad)).reshape(batch, -1, z)
        masks = list(self.masks.to(llr_int.dtype))

        def vn_phase(c2v):
            """Returns (v2c list CN-aligned, marg [B, C_b, z])."""
            v2c = [None] * len(edges)
            marg = []
            for c in range(self._n_col_blocks):
                eids = col_edges.get(c, [])
                rolled = [torch.roll(c2v[e], edges[e][2], dims=-1)
                          for e in eids]
                tot = llr_vn[:, c]
                for x in rolled:
                    tot = tot + x
                marg.append(torch.clamp(tot, -clip, clip))
                for e, x in zip(eids, rolled):
                    v = torch.clamp(tot - x, -clip, clip)
                    v2c[e] = store(torch.roll(v, -edges[e][2], dims=-1))
            return v2c, torch.stack(marg, dim=1)

        v2c = [store(torch.roll(torch.clamp(llr_vn[:, c], -clip, clip), -s,
                                dims=-1))
               for (r, c, s) in edges]
        marg = llr_vn  # num_iter == 0 -> marginals = input
        for it in range(num_iter):
            if tape is not None:
                tape[it] = torch.stack(v2c)
            c2v = _lifted_cn_phase(v2c, masks, self._row_edges, len(edges),
                                   clip, self._offset, self._cn_mode,
                                   self._edge_full, atanh_form)
            v2c, marg = vn_phase(c2v)
        return marg.reshape(batch, -1)[:, :self._num_vns]

    def decode_layered(self, llr_int, num_iter, storage_dtype=None,
                       tape_marg=None, tape_c2v=None):
        """Plain torch version of the layered (serial-C) schedule, op for
        op as the JAX package's ``decode_layered`` (the layered kernel's
        oracle): base rows are processed in order, each row's new check
        messages updating the posterior at once. Only the check messages
        are clipped; clipping the posterior would break the marg/c2v
        bookkeeping. With bf16 storage the per-edge c2v state is rounded
        to bf16 when stored, and both the row's v2c and the posterior's
        increment subtract the rounded old c2v from the unrounded new
        one, as the Pallas kernel does. llr_int: [batch, num_vns].
        Returns marginals [batch, num_vns]. ``tape_marg`` ([num_iter, C_b,
        batch, Z]) and ``tape_c2v`` ([num_iter, E, batch, Z]), optional,
        receive each iteration's starting posterior and c2v messages (the
        gradient's tape, ``lifted_grad.layered_tape_forward``)."""
        _check_knobs(storage_dtype, "log1p")
        store = _stored(storage_dtype)
        z = self._z
        batch = llr_int.shape[0]
        pad = self._n_col_blocks * z - self._num_vns
        llr_vn = F.pad(llr_int, (0, pad)).reshape(batch, -1, z)
        masks = list(self.masks.to(llr_int.dtype))
        edges = self._edges
        n_e = len(edges)
        marg = [llr_vn[:, c] for c in range(self._n_col_blocks)]
        c2v = [torch.zeros_like(marg[0]) for _ in range(n_e)]
        for it in range(num_iter):
            if tape_marg is not None:
                tape_marg[it] = torch.stack(marg)
                tape_c2v[it] = torch.stack(c2v)
            for r, eids in self._row_edges.items():
                v2c = [None] * n_e
                for e in eids:
                    _, c, s = edges[e]
                    v2c[e] = torch.roll(marg[c], -s, dims=-1) - c2v[e]
                c2v_new = _lifted_cn_phase(
                    v2c, masks, {r: eids}, n_e, self._llr_max,
                    self._offset, self._cn_mode, self._edge_full)
                for e in eids:
                    _, c, s = edges[e]
                    delta = c2v_new[e] - c2v[e]
                    marg[c] = marg[c] + torch.roll(delta, s, dims=-1)
                    c2v[e] = store(c2v_new[e])
        out = torch.stack(marg, dim=1).reshape(batch, -1)
        return out[:, :self._num_vns]


def _check_grad_knobs(storage_dtype, atanh_form):
    """Raises for the knobs the gradient path does not take: the JAX
    package differentiates its XLA lifted engine (f32 messages, the log1p
    form); bf16 storage and the ratio form exist only in its Pallas
    kernel, which has no VJP."""
    if storage_dtype is not None or atanh_form != "log1p":
        raise RuntimeError(
            "the lifted engine's gradient takes f32 message storage and "
            "the log1p form only: bf16 storage and atanh_form='ratio' are "
            "knobs of the JAX package's Pallas kernel, which has no "
            "gradient; decode under torch.no_grad() or detach the LLRs")


def _check_llrs(kern, lifted, llr_int, num_iter, storage_dtype,
                atanh_form):
    """Raises unless ``llr_int`` is what the lifted BP kernel ``kern``
    takes: f32 CUDA LLRs [batch, num_vns], on the device of ``lifted``'s
    tables, with a nonnegative int ``num_iter`` and the Pallas kernel's
    knobs, and no grad to keep (the kernel computes none: the gradient
    path is ``LDPC5GLiftedBP``'s, through K5)."""
    name = f"{kern.name} kernel"
    if not llr_int.is_cuda:
        raise ValueError(f"the {name} needs a CUDA tensor")
    if llr_int.dtype != torch.float32:
        raise TypeError(f"the {name} takes float32, got {llr_int.dtype}")
    if torch.is_grad_enabled() and llr_int.requires_grad:
        raise RuntimeError(f"the {name} computes no gradient; call the "
                           "LDPC5GLiftedBP module, which runs the K5 kernels "
                           "for LLRs that require grad")
    if llr_int.dim() != 2 or llr_int.shape[1] != lifted._num_vns:
        raise ValueError(f"expected LLRs [batch, {lifted._num_vns}], got "
                         f"{tuple(llr_int.shape)}")
    if lifted.masks.device != llr_int.device:
        raise ValueError(f"LLRs are on {llr_int.device} but the decoder's "
                         f"tables are on {lifted.masks.device}")
    if not isinstance(num_iter, int) or num_iter < 0:
        raise ValueError("num_iter must be a nonnegative int.")
    _check_knobs(storage_dtype, atanh_form)


def _variant(lifted, storage_dtype, atanh_form):
    """The launch-count variant: "f32" or "bf16", "+ratio" for the ratio
    form, "+minsum" for the (offset) min-sum check node."""
    return (("bf16" if storage_dtype is not None else "f32")
            + ("+ratio" if atanh_form == "ratio" else "")
            + ("+minsum" if lifted._cn_mode == "minsum" else ""))


class LiftedBPLayout(NamedTuple):
    """How the flooding kernel K1 lays out one code's message state on
    the card (see :func:`lifted_bp_layout`)."""

    threads: int          # threads per block
    cluster: int          # blocks per codeword (a thread-block cluster)
    smem_bytes: int       # dynamic shared memory per block
    state_floats: int     # shared slots per block, in floats
    reg_edges: tuple      # edges whose slots live in registers
    slots: tuple          # per edge: (owner block, index) or None
    ranges: tuple         # per edge: cyclic active lanes (lo, length)
    reg_units_per_thread: int
    n_reg_rows: int
    n_plain_rows: int
    n_vn_cols: int
    plan: np.ndarray      # int32 tables the kernel copies to shared memory


def _cyclic_range(mask):
    """(lo, length) such that lane l is active iff (l - lo) mod Z <
    length, or None when the active lanes of ``mask`` are not one cyclic
    range."""
    act = np.asarray(mask) > 0
    z = act.size
    n = int(act.sum())
    if n in (0, z):
        return (0, n)
    starts = np.flatnonzero(act & ~np.roll(act, 1))
    if len(starts) != 1:
        return None
    return (int(starts[0]), n)


def _check_rows_and_ranges(lifted, rows, name):
    """Each edge's cyclic active-lane range (``_cyclic_range``); raises
    ValueError for a row degree outside ``CN_ROW_DEGREES`` or a mask that
    is not one cyclic range, which no layout of kernel ``name`` takes."""
    degrees = {len(r) for r in rows if r} - CN_ROW_DEGREES
    if degrees:
        raise ValueError(f"no {name} layout takes a row degree of "
                         f"{sorted(degrees)}")
    ranges = tuple(_cyclic_range(m) for m in lifted._edge_mask)
    if any(r is None for r in ranges):
        raise ValueError(f"no {name} layout takes an edge mask that is not "
                         "one cyclic range of lanes")
    return ranges


def _pack_plan(arrays, align=1):
    """The int32 plan of a list of int arrays: their offsets, then the
    arrays, each (and the offsets) zero-padded to a multiple of ``align``
    ints."""
    parts = [np.zeros(len(arrays), np.int64)] + \
        [np.asarray(a, np.int64) for a in arrays]
    parts = [np.pad(x, (0, -len(x) % align)) for x in parts]
    parts[0][:len(arrays)] = np.cumsum([len(x) for x in parts])[:-1]
    return np.concatenate(parts).astype(np.int32)


class _FloodingTables(NamedTuple):
    """What the flooding kernels' layouts (K1's, K5b's) take from the code
    alone (see :func:`_flooding_tables`)."""

    rows: list         # per base row, its edge ids
    cols: list         # per base column, its edge ids
    ranges: tuple      # per edge: cyclic active lanes (lo, length)
    reg_of_row: dict   # row -> position of its register edge in the row
    reg_rows: list     # the rows with a register edge, in order
    reg_edges: tuple   # their register edges
    plain_rows: list   # the other rows that have edges
    vn_cols: list      # the columns without a register edge
    shared: list       # the edges whose slots live in shared memory
    plan_len: int      # ints of the plan


def _flooding_tables(lifted, name):
    """The register edges (each base row's first edge whose column has
    degree 1), the rows and columns around them and the length of the
    plan of a flooding kernel's layout (K1's or K5b's, ``name``) for the
    code of ``lifted``. Raises ValueError for a row degree outside
    ``CN_ROW_DEGREES`` or a mask that is not one cyclic range."""
    edges = lifted._edges
    n_e = len(edges)
    n_rows, n_cols = lifted._n_row_blocks, lifted._n_col_blocks
    rows = [lifted._row_edges.get(r, []) for r in range(n_rows)]
    cols = [lifted._col_edges.get(c, []) for c in range(n_cols)]
    ranges = _check_rows_and_ranges(lifted, rows, name)
    reg_of_row = {}
    for r, eids in enumerate(rows):
        for p, e in enumerate(eids):
            if len(cols[edges[e][1]]) == 1:
                reg_of_row[r] = p
                break
    reg_rows = sorted(reg_of_row)
    reg_edges = tuple(rows[r][reg_of_row[r]] for r in reg_rows)
    reg_cols = {edges[e][1] for e in reg_edges}
    plain_rows = [r for r in range(n_rows) if rows[r] and r not in reg_of_row]
    vn_cols = [c for c in range(n_cols) if c not in reg_cols]
    shared = [e for e in range(n_e) if e not in set(reg_edges)]
    plan_len = len(K1_PLAN_ARRAYS) + n_rows + 1 + n_cols + 1 + 4 * n_e + \
        4 * len(reg_rows) + len(plain_rows) + len(vn_cols)
    return _FloodingTables(rows, cols, ranges, reg_of_row, reg_rows,
                           reg_edges, plain_rows, vn_cols, shared, plan_len)


def _flooding_slots(tables, n_edges, cluster):
    """Per edge its slot (owner block, index) or None (a register edge):
    the shared edges split into ``cluster`` contiguous groups of edge
    ids, one per block. Returns (slots, the most slots of a block)."""
    shared = tables.shared
    slots = [None] * n_edges
    counts = [0] * cluster
    for m, e in enumerate(shared):
        owner = m * cluster // len(shared)
        slots[e] = (owner, counts[owner])
        counts[owner] += 1
    return tuple(slots), max(counts)


def _flooding_plan(lifted, tables, slots):
    """The int32 plan (``K1_PLAN_ARRAYS``) of a flooding kernel's layout:
    the row and column tables with each edge's slot id (owner block << 16
    | index, -1 for a register edge), range and shift, and the register
    and plain rows and the VN columns."""
    edges = lifted._edges
    t = tables

    def slot_id(e):
        return -1 if slots[e] is None else (slots[e][0] << 16) | slots[e][1]

    row_ptr, row_ids = _csr(dict(enumerate(t.rows)), len(t.rows))
    col_ptr, col_ids = _csr(dict(enumerate(t.cols)), len(t.cols))
    arrays = [
        row_ptr,
        [slot_id(e) for e in row_ids],
        [t.ranges[e][0] | (t.ranges[e][1] << 16) for e in row_ids],
        col_ptr,
        [slot_id(e) for e in col_ids],
        [edges[e][2] for e in col_ids],
        t.reg_rows,
        [t.reg_of_row[r] for r in t.reg_rows],
        [edges[e][1] for e in t.reg_edges],
        [edges[e][2] for e in t.reg_edges],
        t.plain_rows,
        t.vn_cols,
    ]
    plan = _pack_plan(arrays)
    assert len(arrays) == len(K1_PLAN_ARRAYS) and plan.size == t.plan_len
    return plan


def lifted_bp_layout(lifted):
    """The layout of K1 (``csrc/ldpc_lifted_bp.cu``) for the code of
    ``lifted``: which edges keep their message slots in registers, how
    many blocks share one codeword, the shared-memory bytes, the threads
    per block and the int32 plan the kernel reads. Plain Python, run once
    per decoder.

    - Register edges: each base row's first edge whose column has degree
      1; the thread of CN unit (row, lane) keeps that lane's slot and
      updates the column itself.
    - Every other edge has one f32 slot per lane in shared memory. When
      they do not fit one block (``SMEM_PER_BLOCK``, with the plan), the
      codeword takes a cluster of 2-8 blocks and the shared edges are
      split into contiguous groups of edge ids, one group per block.
    - Cluster: the fewest blocks whose shared memory holds the slots and
      whose threads hold the register edges' lanes in at most
      ``K1_REG_UNITS`` registers each.
    - Threads: enough for one CN or VN unit each, up to
      ``K1_MAX_THREADS`` per block (512: with the 128 registers a thread
      of K1 takes, the most one SM holds).
    - Each edge's mask (``lifted.masks``) becomes one cyclic range of
      active lanes.

    Raises ValueError for a code that no layout takes (a row degree
    outside ``CN_ROW_DEGREES``, a mask that is not one cyclic range, no
    cluster of up to ``K1_MAX_CLUSTER`` blocks that holds the state)."""
    z = lifted._z
    t = _flooding_tables(lifted, "K1")
    units = max(len(t.rows) * z, len(t.vn_cols) * z)
    for cluster in range(1, K1_MAX_CLUSTER + 1):
        per_block = -(-len(t.shared) // cluster)
        if (per_block * z + t.plan_len) * 4 > SMEM_PER_BLOCK:
            continue
        threads = min(K1_MAX_THREADS, -(-units // (cluster * 32)) * 32)
        per_thread = -(-len(t.reg_rows) * z // (cluster * threads))
        if per_thread <= K1_REG_UNITS[cluster > 1]:
            break
    else:
        raise ValueError(
            f"no K1 layout takes this code: {len(t.shared)} shared edges "
            f"and {len(t.reg_rows)} register edges of {z} lanes need more "
            f"than {K1_MAX_CLUSTER} blocks of {K1_MAX_THREADS} threads")
    slots, per_block = _flooding_slots(t, len(lifted._edges), cluster)
    state_floats = per_block * z
    return LiftedBPLayout(
        threads=threads, cluster=cluster,
        smem_bytes=(state_floats + t.plan_len) * 4,
        state_floats=state_floats, reg_edges=t.reg_edges, slots=slots,
        ranges=t.ranges, reg_units_per_thread=per_thread,
        n_reg_rows=len(t.reg_rows), n_plain_rows=len(t.plain_rows),
        n_vn_cols=len(t.vn_cols), plan=_flooding_plan(lifted, t, slots))


class LayeredBPLayout(NamedTuple):
    """How the layered kernel K3 lays out one code's message state on the
    card (see :func:`layered_bp_layout`)."""

    threads: int          # threads per block: a multiple of lanes
    cluster: int          # blocks per codeword (a thread-block cluster)
    smem_bytes: int       # dynamic shared memory per block
    lanes: int            # lanes per block: block b owns [b * lanes, ...)
    steps: tuple          # row steps: (first row, end row), rows in order
    step_degree: int      # edges of the largest step: the scratch's rows
    slots: tuple          # per edge: its c2v slot (position in row order)
    ranges: tuple         # per edge: cyclic active lanes (lo, length)
    plan: np.ndarray      # int32 tables the kernel copies to shared memory


def _row_steps(lifted, rows):
    """The rows in order, cut into steps of consecutive rows that share no
    column (each step as (first row, end row)): within a step the rows'
    updates touch disjoint posterior columns, so running them together
    computes what running them one after another does."""
    steps, start, used = [], 0, set()
    for r, eids in enumerate(rows):
        cols = {lifted._edges[e][1] for e in eids}
        if cols & used:
            steps.append((start, r))
            start, used = r, set()
        used |= cols
    steps.append((start, len(rows)))
    return tuple(steps)


class _LayeredBPPlan(NamedTuple):
    """What K3's layout takes from the code alone, whatever the storage
    type (see :func:`_layered_bp_plan`)."""

    steps: tuple
    step_degree: int
    slots: tuple
    ranges: tuple
    plan: np.ndarray


def _layered_bp_plan(lifted, name="K3"):
    """K3's row steps, the edges of its largest step, each edge's c2v slot
    and cyclic active-lane range, and the int32 plan (the same for both
    storage types; see :func:`layered_bp_layout`; K5Lb reads the same
    plan). Raises ValueError, naming kernel ``name``, for a row degree
    outside ``CN_ROW_DEGREES`` or a mask that is not one cyclic range."""
    z = lifted._z
    edges = lifted._edges
    n_rows = lifted._n_row_blocks
    rows = [lifted._row_edges.get(r, []) for r in range(n_rows)]
    ranges = _check_rows_and_ranges(lifted, rows, name)
    steps = _row_steps(lifted, rows)
    row_ptr, row_ids = _csr(dict(enumerate(rows)), n_rows)
    arrays = [
        [x for e in row_ids for x in (edges[e][1] * z + edges[e][2],
                                      z - edges[e][2], *ranges[e])],
        [first for first, _ in steps] + [n_rows],
        row_ptr,
    ]
    plan = _pack_plan(arrays, align=4)
    assert len(arrays) == len(K3_PLAN_ARRAYS)
    slots = [None] * len(edges)
    for p, e in enumerate(row_ids):
        slots[e] = p
    return _LayeredBPPlan(
        steps=steps,
        step_degree=max(row_ptr[end] - row_ptr[first]
                        for first, end in steps),
        slots=tuple(slots), ranges=ranges, plan=plan)


def layered_bp_layout(lifted, storage_dtype=None):
    """The layout of K3 (``csrc/ldpc_layered_bp.cu``) for the code of
    ``lifted`` with c2v stored as ``storage_dtype`` (None: f32, or
    torch.bfloat16): how many blocks share one codeword, the lanes each
    owns, the shared-memory bytes, the threads per block, the row steps
    and the int32 plan the kernel reads. Plain Python, run once per
    decoder and storage type.

    - Row steps: consecutive rows that share no column run as one step
      (``_row_steps``; 21 steps for the 24 rows of the n=12288 code).
    - Shared memory of each block: two mbarriers (16 B), the whole posterior
      (f32; in a cluster each block holds a replica), a [step degree,
      lanes] f32 check-node scratch, the plan, and one c2v slot per edge
      for its lanes (4 or 2 B a lane).
    - Cluster: the fewest blocks (up to ``K3_MAX_CLUSTER``) whose shared
      memory (``SMEM_PER_BLOCK``) holds that when the Z lanes of the c2v
      slots are split into equal runs, one per block (2 for f32 at
      n=12288, 3 for f32 at n=16896, 5 for f32 at n=25344).
    - Threads: m per lane, each on one lane throughout, with m the most
      that keeps the threads of the blocks one SM holds (by shared
      memory) within ``K3_SM_THREADS`` and a block's within
      ``K3_MAX_THREADS``, at least 1 and at most the step degree.
    - The plan (``_layered_bp_plan``): per edge in row order (its c2v
      slot) a record of four ints, column * Z + shift and Z - shift (the
      posterior offset and the lane where it wraps) and its cyclic
      active-lane range (lo, length), which replaces the edge's mask; the
      step pointers (into the rows), and the row pointers.

    Raises ValueError for a code that no layout takes (a row degree
    outside ``CN_ROW_DEGREES``, a mask that is not one cyclic range, a
    state too large for ``K3_MAX_CLUSTER`` blocks)."""
    _check_knobs(storage_dtype, "log1p")
    z = lifted._z
    n_cols, n_edges = lifted._n_col_blocks, len(lifted._edges)
    tables = _layered_bp_plan(lifted)
    msg_bytes = 4 if storage_dtype is None else 2
    for cluster in range(1, K3_MAX_CLUSTER + 1):
        lanes = -(-z // cluster)
        if (cluster - 1) * lanes >= z:  # a block would own no lane
            continue
        smem = 16 + (n_cols * z + tables.step_degree * lanes
                     + tables.plan.size) * 4 + n_edges * lanes * msg_bytes
        if smem <= SMEM_PER_BLOCK and lanes <= K3_MAX_THREADS:
            break
    else:
        raise ValueError(
            f"no K3 layout takes this code: {n_cols} columns and "
            f"{n_edges} edges of {z} lanes need more than "
            f"{K3_MAX_CLUSTER} blocks")
    blocks_per_sm = max(1, SMEM_PER_SM // (smem + 1024))
    per_lane = max(1, min(tables.step_degree, K3_MAX_THREADS // lanes,
                          K3_SM_THREADS // (blocks_per_sm * lanes)))
    return LayeredBPLayout(
        threads=per_lane * lanes, cluster=cluster, smem_bytes=smem,
        lanes=lanes, steps=tables.steps, step_degree=tables.step_degree,
        slots=tables.slots, ranges=tables.ranges, plan=tables.plan)


def lifted_bp_cuda(lifted, llr_int, num_iter, storage_dtype=None,
                   atanh_form="log1p"):
    """Runs the flooding lifted BP decode as one launch of the CUDA
    kernel ``csrc/ldpc_lifted_bp.cu`` (K1) on the current stream, in the
    layout of :func:`lifted_bp_layout`, and counts it under its variant.

    llr_int: contiguous-able f32 CUDA tensor [batch, num_vns] of
    classic-convention LLRs, on the device of ``lifted``'s tables.
    ``storage_dtype`` (None or torch.bfloat16) and ``atanh_form``
    ("log1p" or "ratio") are the Pallas kernel's knobs. Returns
    marginals [batch, num_vns]. Raises on anything the kernel does not
    take; the gradient path is ``LDPC5GLiftedBP``'s (K5f and K5b)."""
    kern = LIFTED_BP_KERNEL
    _check_llrs(kern, lifted, llr_int, num_iter, storage_dtype, atanh_form)
    z = lifted._z
    batch = llr_int.shape[0]
    n_cols = lifted._n_col_blocks
    llr_p = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).contiguous()
    out = torch.empty_like(llr_p)
    if batch == 0:
        return out[:, :lifted._num_vns]
    lib = kern.library()
    layout = lifted.k1_layout()
    plan = lifted.k1_plan(llr_int.device)
    with torch.cuda.device(llr_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sionna_ldpc_lifted_bp(
            llr_p.data_ptr(), plan.data_ptr(), out.data_ptr(), batch,
            n_cols, z, layout.n_reg_rows, layout.n_plain_rows,
            layout.n_vn_cols, layout.state_floats, plan.numel(), num_iter,
            lifted._llr_max, lifted._offset,
            0 if lifted._cn_mode == "boxplus" else 1,
            int(storage_dtype is not None), int(atanh_form == "ratio"),
            layout.threads, layout.cluster, stream)
    kern.check(err)
    kern.count(_variant(lifted, storage_dtype, atanh_form))
    return out[:, :lifted._num_vns]


def layered_bp_cuda(lifted, llr_int, num_iter, storage_dtype=None):
    """Runs the layered lifted BP decode as one launch of the CUDA kernel
    ``csrc/ldpc_layered_bp.cu`` (K3) on the current stream.

    Takes and returns what :func:`lifted_bp_cuda` does, without
    ``atanh_form`` (the layered schedule uses the log1p form), in the
    layout of :func:`layered_bp_layout` for ``storage_dtype``: the
    posterior and the c2v state (f32 or bf16) live in shared memory, so
    nothing but the output is allocated here. Raises on anything the
    kernel does not take; the gradient path is ``LDPC5GLiftedBP``'s (K5Lf
    and K5Lb)."""
    kern = LAYERED_BP_KERNEL
    _check_llrs(kern, lifted, llr_int, num_iter, storage_dtype, "log1p")
    z = lifted._z
    batch = llr_int.shape[0]
    n_cols = lifted._n_col_blocks
    llr_p = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).contiguous()
    out = torch.empty_like(llr_p)
    if batch == 0:
        return out[:, :lifted._num_vns]
    lib = kern.library()
    layout = lifted.k3_layout(storage_dtype)
    plan = lifted.k3_plan(llr_int.device)
    with torch.cuda.device(llr_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sionna_ldpc_layered_bp(
            llr_p.data_ptr(), plan.data_ptr(), out.data_ptr(), batch,
            len(layout.steps), n_cols, len(lifted._edges), z, layout.lanes,
            layout.step_degree, plan.numel(), num_iter,
            lifted._llr_max, lifted._offset,
            0 if lifted._cn_mode == "boxplus" else 1,
            int(storage_dtype is not None), layout.threads, layout.cluster,
            stream)
    kern.check(err)
    kern.count(_variant(lifted, storage_dtype, "log1p"))
    return out[:, :lifted._num_vns]
