"""5G LDPC belief-propagation decoding in the lifted domain.

PyTorch counterpart of the lifted engine of
``sionna_tpu/phy/fec/ldpc/decoding.py``: :class:`LDPC5GDecoder` with the
5G rate recovery, :class:`LDPC5GLiftedBP` (tables and the plain torch
decodes, flooding and layered) and the wrappers of the two hand-written
CUDA kernels that replace the Pallas kernel ``_lifted_pallas_decode``:
:func:`lifted_bp_cuda` (flooding, ``csrc/ldpc_lifted_bp.cu``) and
:func:`layered_bp_cuda` (layered, ``csrc/ldpc_layered_bp.cu``).

Which one runs depends only on where the LLRs lie: a CPU tensor goes
through the plain decode, a CUDA tensor through the kernel. A CUDA
tensor never falls back to the plain decode; if the kernel cannot build
or launch, the call raises.

LLRs follow the package logit convention log(P1/P0); the BP engine
works in the classic log(P0/P1) convention (input and output negated).
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...block import Block
from ...._build import CudaKernel
from .encoding import LDPC5GEncoder

__all__ = ["LDPC5GDecoder", "LDPC5GLiftedBP", "lifted_bp_cuda",
           "layered_bp_cuda", "LIFTED_BP_KERNEL", "LAYERED_BP_KERNEL"]

_ROADMAP_SEGMENT = ("the segment/matmul BP engines (generic "
                    "parity-check matrices, callbacks, return_state) are "
                    "not ported yet: see ROADMAP.md, queue 1 item 5")
_CN_UPDATES = ("minsum", "offset-minsum", "boxplus", "boxplus-phi")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: The CUDA kernel of the lifted BP decoder (built on first use).
LIFTED_BP_KERNEL = CudaKernel(
    name="ldpc_lifted_bp",
    source="ldpc_lifted_bp.cu",
    replaces="sionna_tpu/phy/fec/ldpc/decoding.py:1106",
    functions={
        "sionna_ldpc_lifted_bp": ([_P] * 10 + [_I] * 6 + [_F, _F, _I, _P],
                                  _I),
        "sionna_ldpc_max_degree": ([], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    })

#: The CUDA kernel of the layered lifted BP decoder (built on first use).
LAYERED_BP_KERNEL = CudaKernel(
    name="ldpc_layered_bp",
    source="ldpc_layered_bp.cu",
    replaces="sionna_tpu/phy/fec/ldpc/decoding.py:1203",
    functions={
        "sionna_ldpc_layered_bp": ([_P] * 8 + [_I] * 6 + [_F, _F, _I, _P],
                                   _I),
        "sionna_ldpc_max_degree": ([], _I),
        "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
    })


class LDPC5GDecoder(Block):
    """5G NR LDPC decoder with rate recovery for an associated
    :class:`LDPC5GEncoder`.

    ``engine`` "auto", "lifted" and "pallas" all select the lifted
    engine: the plain torch decode for CPU tensors, the CUDA kernel for
    CUDA tensors. ``cn_update`` may be "boxplus" or "boxplus-phi" (both
    the exact tanh rule), "minsum" or "offset-minsum" (offset 0.5);
    ``cn_schedule`` "flooding" or "layered" (one layer per lifted base
    row), with f32 (or, on the CPU, f64) messages. ``internal_precision``
    may be None or "bf16"; as in the JAX package, the lifted engine does
    not read it.
    """

    def __init__(self, encoder, cn_update="boxplus-phi",
                 cn_schedule="flooding", hard_out=True,
                 return_infobits=True, num_iter=20, llr_max=20.,
                 return_state=False, internal_precision=None,
                 engine="auto", precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(encoder, LDPC5GEncoder):
            raise TypeError("encoder must be of class LDPC5GEncoder.")
        if engine in ("segment", "matmul"):
            raise NotImplementedError(f"engine='{engine}': "
                                      + _ROADMAP_SEGMENT)
        if engine not in ("auto", "lifted", "pallas"):
            raise ValueError("engine must be 'auto', 'lifted', 'pallas', "
                             "'segment' or 'matmul'")
        if isinstance(cn_schedule, (list, tuple, np.ndarray)):
            raise NotImplementedError("custom CN schedules: "
                                      + _ROADMAP_SEGMENT)
        if cn_schedule not in ("flooding", "layered"):
            raise ValueError(
                "cn_schedule must be 'flooding', 'layered', or a "
                "list of CN-index arrays")
        if internal_precision not in (None, "bf16"):
            raise ValueError("internal_precision must be None or 'bf16'")
        if callable(cn_update):
            raise NotImplementedError("custom CN updates: "
                                      + _ROADMAP_SEGMENT)
        if cn_update not in _CN_UPDATES:
            raise ValueError(f"Unknown cn_update: {cn_update}")
        if return_state:
            raise ValueError(
                "engine='lifted'/'pallas' does not keep per-edge "
                "message state; use engine='segment' (or "
                "engine='auto', which falls back automatically) "
                "when return_state=True")
        if not isinstance(hard_out, bool):
            raise TypeError("hard_out must be bool.")
        if not isinstance(num_iter, int) or num_iter < 0:
            raise ValueError("num_iter must be a nonnegative int.")

        if encoder.device != self.device:
            raise ValueError(f"the encoder is on {encoder.device}, the "
                             f"decoder on {self.device}")
        self.encoder = encoder
        self._hard_out = hard_out
        self._return_infobits = bool(return_infobits)
        self._num_iter = num_iter
        self._llr_max = float(llr_max)
        self._layered = cn_schedule == "layered"

        # prune the degree-1 parity VNs that are never transmitted
        pcm = encoder.pcm
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
        self._nb_pruned_nodes = encoder.n_ldpc - int(
            max(last_pos, encoder.n_ldpc - nb_punc_bits))
        self._num_cns = pcm.shape[0] - self._nb_pruned_nodes
        self._num_vns = pcm.shape[1] - self._nb_pruned_nodes

        self.lifted = LDPC5GLiftedBP(
            encoder, self._num_cns, self._num_vns, self._llr_max,
            offset=0.5 if cn_update == "offset-minsum" else 0.0,
            cn_mode="boxplus" if cn_update in ("boxplus", "boxplus-phi")
            else "minsum", device=self.device)

    @property
    def num_cns(self):
        return self._num_cns

    @property
    def num_vns(self):
        return self._num_vns

    @property
    def num_iter(self):
        return self._num_iter

    def recover_llrs(self, llr_ch):
        """Rate recovery: channel LLRs [..., n] (logit convention) ->
        classic-convention LLRs [B, num_vns], the BP engine's input.

        Undoes the output interleaver, restores the 2Z punctured and the
        unsent parity positions as zeros (unknown), sets the filler bits
        to a strongly known zero and clips to ``llr_max``."""
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
        llr_5g = torch.cat(
            [llr_5g[:, :enc.k],
             torch.full((batch, k_filler), -self._llr_max, dtype=dt,
                        device=dev),
             llr_5g[:, enc.k:enc.k + nb_par_bits]], dim=1)
        return -torch.clamp(llr_5g, -self._llr_max, self._llr_max)

    def forward(self, llr_ch, num_iter=None, msg_v2c=None):
        if msg_v2c is not None:
            raise ValueError(
                "engine='lifted'/'pallas' cannot warm-start from "
                "msg_v2c; use engine='segment' for state "
                "round-tripping")
        n_it = self._num_iter if num_iter is None else num_iter
        if not isinstance(n_it, int) or n_it < 0:
            raise ValueError("num_iter must be a nonnegative int.")
        in_shape = llr_ch.shape
        enc = self.encoder
        llr_out = -self.lifted(self.recover_llrs(llr_ch), n_it,
                               layered=self._layered)
        x_hat = (llr_out > 0).to(self.rdtype) if self._hard_out else llr_out

        if self._return_infobits:
            return x_hat[:, :enc.k].reshape(tuple(in_shape[:-1])
                                            + (enc.k,))
        x_no_filler = torch.cat([x_hat[:, :enc.k], x_hat[:, enc.k_ldpc:]],
                                dim=1)
        x_short = x_no_filler[:, 2 * enc.z:2 * enc.z + enc.n]
        if enc.out_int is not None:
            x_short = x_short[:, enc.out_int]
        return x_short.reshape(in_shape)


def _lifted_cn_phase(v2c, masks, row_edges, n_edges, clip, offset, mode,
                     full):
    """CN phase of the plain lifted engine, op for op as the JAX
    package's ``_lifted_cn_phase`` (``atanh_form="log1p"``).

    ``v2c``: list of [B, Z] CN-aligned messages; ``masks``: list of [Z]
    activity masks; ``full[e]`` marks edges whose mask is all ones (their
    mask selects are skipped). ``mode="minsum"``: two-minima tracking
    with optional offset. ``mode="boxplus"``: tanh rule with prefix and
    suffix products, extrinsic clamped at 1 - 1e-7, magnitude
    log1p(x) - log1p(-x)."""
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

    Calling the module decodes with the plain torch version on a CPU
    tensor and with the CUDA kernel of the schedule on a CUDA tensor.
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

        def buf(name, values, dtype=torch.int32):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(values), dtype=dtype,
                                      device=device), persistent=False)

        row_ptr, row_ids = _csr(self._row_edges, n_row_blocks)
        col_ptr, col_ids = _csr(self._col_edges, n_col_blocks)
        self._max_degree = max(
            max(len(v) for v in self._row_edges.values()),
            max(len(v) for v in self._col_edges.values()))
        buf("masks", np.stack(self._edge_mask), torch.float32)  # [E_b, Z]
        buf("edge_col", [c for (_, c, _) in edges])
        buf("edge_shift", [s for (_, _, s) in edges])
        buf("row_ptr", row_ptr)
        buf("row_edge_ids", row_ids)
        buf("col_ptr", col_ptr)
        buf("col_edge_ids", col_ids)

    def numpy_structure(self):
        """The lifted graph as NumPy arrays, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {"edges": np.asarray(self._edges, np.int64).reshape(-1, 3),
                "edge_mask": np.stack(self._edge_mask)}

    def forward(self, llr_int, num_iter, layered=False):
        """llr_int: [batch, num_vns] classic-convention LLRs. Returns
        marginals [batch, num_vns] after ``num_iter`` flooding or
        (``layered``) layered iterations."""
        if llr_int.is_cuda:
            return (layered_bp_cuda if layered else lifted_bp_cuda)(
                self, llr_int, num_iter)
        if llr_int.device.type != "cpu":
            raise ValueError(f"no lifted BP decoder for {llr_int.device}")
        if layered:
            return self.decode_layered(llr_int, num_iter)
        return self.decode(llr_int, num_iter)

    def decode(self, llr_int, num_iter):
        """Plain torch version of the lifted BP iteration (the kernel's
        oracle). llr_int: [batch, num_vns] classic-convention LLRs.
        Returns marginals [batch, num_vns]."""
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
                    v2c[e] = torch.roll(v, -edges[e][2], dims=-1)
            return v2c, torch.stack(marg, dim=1)

        v2c = [torch.roll(torch.clamp(llr_vn[:, c], -clip, clip), -s,
                          dims=-1)
               for (r, c, s) in edges]
        marg = llr_vn  # num_iter == 0 -> marginals = input
        for _ in range(num_iter):
            c2v = _lifted_cn_phase(v2c, masks, self._row_edges, len(edges),
                                   clip, self._offset, self._cn_mode,
                                   self._edge_full)
            v2c, marg = vn_phase(c2v)
        return marg.reshape(batch, -1)[:, :self._num_vns]

    def decode_layered(self, llr_int, num_iter):
        """Plain torch version of the layered (serial-C) schedule, op for
        op as the JAX package's ``decode_layered`` (the layered kernel's
        oracle): base rows are processed in order, each row's new check
        messages updating the posterior at once. Only the check messages
        are clipped; clipping the posterior would break the marg/c2v
        bookkeeping. llr_int: [batch, num_vns]. Returns marginals
        [batch, num_vns]."""
        z = self._z
        batch = llr_int.shape[0]
        pad = self._n_col_blocks * z - self._num_vns
        llr_vn = F.pad(llr_int, (0, pad)).reshape(batch, -1, z)
        masks = list(self.masks.to(llr_int.dtype))
        edges = self._edges
        n_e = len(edges)
        marg = [llr_vn[:, c] for c in range(self._n_col_blocks)]
        c2v = [torch.zeros_like(marg[0]) for _ in range(n_e)]
        for _ in range(num_iter):
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
                    c2v[e] = c2v_new[e]
        out = torch.stack(marg, dim=1).reshape(batch, -1)
        return out[:, :self._num_vns]


def _launch(kern, entry, lifted, llr_int, num_iter, tables):
    """Checks the input, then runs one launch of the lifted BP kernel
    ``kern`` through its C entry point ``entry`` on the current stream
    (arguments: padded LLRs, ``tables``, output, a [batch, E_b, Z]
    scratch buffer, the sizes and the CN rule) and counts it. Returns
    marginals [batch, num_vns]."""
    name = f"{kern.name} kernel"
    if not llr_int.is_cuda:
        raise ValueError(f"the {name} needs a CUDA tensor")
    if llr_int.dtype != torch.float32:
        raise TypeError(f"the {name} takes float32, got {llr_int.dtype}")
    if llr_int.requires_grad:
        raise RuntimeError(f"the {name} has no backward; decode under "
                           "torch.no_grad() or detach the LLRs")
    if llr_int.dim() != 2 or llr_int.shape[1] != lifted._num_vns:
        raise ValueError(f"expected LLRs [batch, {lifted._num_vns}], got "
                         f"{tuple(llr_int.shape)}")
    if lifted.masks.device != llr_int.device:
        raise ValueError(f"LLRs are on {llr_int.device} but the decoder's "
                         f"tables are on {lifted.masks.device}")
    if not isinstance(num_iter, int) or num_iter < 0:
        raise ValueError("num_iter must be a nonnegative int.")
    z = lifted._z
    batch = llr_int.shape[0]
    n_cols = lifted._n_col_blocks
    n_edges = len(lifted._edges)
    llr_p = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).contiguous()
    out = torch.empty_like(llr_p)
    if batch == 0:
        return out[:, :lifted._num_vns]
    scratch = torch.empty((batch, n_edges, z), dtype=torch.float32,
                          device=llr_int.device)
    lib = kern.library()
    if lifted._max_degree > lib.sionna_ldpc_max_degree():
        raise ValueError(f"base-graph degree {lifted._max_degree} exceeds "
                         "the kernel's bound")
    with torch.cuda.device(llr_int.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            llr_p.data_ptr(), *(t.data_ptr() for t in tables),
            out.data_ptr(), scratch.data_ptr(), batch, lifted._n_row_blocks,
            n_cols, n_edges, z, num_iter, lifted._llr_max, lifted._offset,
            0 if lifted._cn_mode == "boxplus" else 1, stream)
    kern.check(err)
    kern.launches += 1
    return out[:, :lifted._num_vns]


def lifted_bp_cuda(lifted, llr_int, num_iter):
    """Runs the flooding lifted BP decode as one launch of the CUDA
    kernel ``csrc/ldpc_lifted_bp.cu`` on the current stream.

    llr_int: contiguous-able f32 CUDA tensor [batch, num_vns] of
    classic-convention LLRs, on the device of ``lifted``'s tables.
    Returns marginals [batch, num_vns]. Raises on anything the kernel
    does not take; it has no backward."""
    return _launch(LIFTED_BP_KERNEL, "sionna_ldpc_lifted_bp", lifted,
                   llr_int, num_iter,
                   (lifted.masks, lifted.edge_col, lifted.edge_shift,
                    lifted.row_ptr, lifted.row_edge_ids, lifted.col_ptr,
                    lifted.col_edge_ids))


def layered_bp_cuda(lifted, llr_int, num_iter):
    """Runs the layered lifted BP decode as one launch of the CUDA kernel
    ``csrc/ldpc_layered_bp.cu`` on the current stream.

    Takes and returns what :func:`lifted_bp_cuda` does. Raises on
    anything the kernel does not take; it has no backward."""
    return _launch(LAYERED_BP_KERNEL, "sionna_ldpc_layered_bp", lifted,
                   llr_int, num_iter,
                   (lifted.masks, lifted.edge_col, lifted.edge_shift,
                    lifted.row_ptr, lifted.row_edge_ids))
