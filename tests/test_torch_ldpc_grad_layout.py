"""The layouts of the gradient's backward kernels K5b and K5Lb
(``flooding_grad_layout`` and ``layered_grad_layout`` in
``sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py``), plain Python planners
that run here, for every code that ``chip_smoke.py``'s phases 36-37 and
``tools/kernel_compare.py`` run on the card: what each block holds fits
its shared memory, every edge lane has one owner, the register edges are
the degree-1 columns the kernel takes them for, and a code no layout
takes raises. K5b's schedule is also run here from its plan alone
(``_emulate_k5b``) and held to the plain reverse."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc import lifted_grad as lg
from sionna_tpu_torch.phy.fec.ldpc.decoding import (K1_PLAN_ARRAYS,
                                                    SMEM_PER_BLOCK,
                                                    SMEM_PER_SM,
                                                    _lifted_cn_phase,
                                                    _row_steps,
                                                    layered_bp_layout)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


# (k, n) -> K5b's (cluster, staged, threads) and K5Lb's (gc_on_chip,
# threads): a BG2 code at Z=18, the coded-AWGN link (BG2, Z=104), the
# flagship (BG1, Z=288) and BG1 at Z=384
CODES = {(100, 200): ((1, True, 256), (True, 18)),
         (1024, 2048): ((1, True, 384), (False, 104)),
         (6144, 12288): ((2, False, 384), (False, 288)),
         (8448, 16896): ((3, False, 384), (False, 384))}

_LIFTED = {}


def _lifted(k, n):
    if (k, n) not in _LIFTED:
        _LIFTED[k, n] = LDPC5GDecoder(LDPC5GEncoder(k, n)).lifted
    return _LIFTED[k, n]


def _k1_arrays(lifted, layout):
    """K5b's plan (K1's arrays) by name, read back through its header."""
    plan = layout.plan.astype(np.int64)
    n_e = len(lifted._edges)
    sizes = [lifted._n_row_blocks + 1, n_e, n_e, lifted._n_col_blocks + 1,
             n_e, n_e] + [layout.n_reg_rows] * 4 + \
        [layout.n_plain_rows, layout.n_vn_cols]
    assert plan[0] == len(K1_PLAN_ARRAYS)
    return {name: plan[plan[i]:plan[i] + size]
            for i, (name, size) in enumerate(zip(K1_PLAN_ARRAYS, sizes,
                                                 strict=True))}


@pytest.mark.parametrize("k,n", list(CODES))
def test_flooding_grad_layout(k, n):
    """K5b: each block's two slabs, staged tape rows and plan fit
    SMEM_PER_BLOCK in a cluster of at most 8; every non-register edge has
    one slot (the same index in both slabs), distinct and in bounds; the
    register edges are each row's first edge of a degree-1 column, one
    per row at most, in at most K5B_REG_UNITS registers a thread."""
    lifted = _lifted(k, n)
    layout = lg.flooding_grad_layout(lifted)
    z, edges = lifted._z, lifted._edges
    n_e = len(edges)
    assert (layout.cluster, layout.staged, layout.threads) == CODES[k, n][0]
    assert 1 <= layout.cluster <= lg.K5B_MAX_CLUSTER <= 8
    assert layout.threads % 32 == 0 and \
        layout.threads <= lg.K5B_MAX_THREADS
    assert layout.smem_bytes == 4 * (2 * layout.slab_floats
                                     + layout.plan.size
                                     + 2 * n_e * z * layout.staged)
    assert layout.smem_bytes <= SMEM_PER_BLOCK
    if layout.staged:  # the link: the tape rows of two iterations besides
        assert layout.cluster == 1
    else:  # no room for them
        assert layout.smem_bytes + 8 * n_e * z > SMEM_PER_BLOCK or \
            layout.cluster > 1
    col_deg = {c: len(v) for c, v in lifted._col_edges.items()}
    rows_of_reg = [edges[e][0] for e in layout.reg_edges]
    assert len(rows_of_reg) == len(set(rows_of_reg)) == layout.n_reg_rows
    for e in layout.reg_edges:
        r, c, _ = edges[e]
        assert col_deg[c] == 1
        assert e == next(x for x in lifted._row_edges[r]
                         if col_deg[edges[x][1]] == 1)
        assert layout.slots[e] is None
    assert layout.reg_units_per_thread == -(-layout.n_reg_rows * z // (
        layout.cluster * layout.threads)) <= lg.K5B_REG_UNITS
    shared = [s for s in layout.slots if s is not None]
    assert len(shared) == len(set(shared)) == n_e - layout.n_reg_rows
    assert {o for o, _ in shared} == set(range(layout.cluster))
    assert max(i for _, i in shared) * z + z <= layout.slab_floats
    # the plan: K1's tables, with K5b's slots
    arr = _k1_arrays(lifted, layout)
    np.testing.assert_array_equal(arr["row_ptr"], lifted.row_ptr.numpy())
    assert list(arr["row_slot"]) == [
        -1 if layout.slots[e] is None
        else layout.slots[e][0] << 16 | layout.slots[e][1]
        for e in range(n_e)]
    assert [int(arr["reg_rows"][i]) for i in range(layout.n_reg_rows)] == \
        rows_of_reg
    assert layout.plan.size + 2 * layout.slab_floats <= SMEM_PER_BLOCK // 4
    assert lifted.k1_layout().reg_edges == layout.reg_edges


@pytest.mark.parametrize("k,n", list(CODES))
def test_layered_grad_layout(k, n):
    """K5Lb: one block per codeword whose posterior and dL/dpost, plan
    and (where the layout keeps it on chip) per-edge dL/dc2v fit
    SMEM_PER_BLOCK; m threads per lane, so every lane of every edge has
    one thread per row of a step; K3's plan and row steps; dL/dc2v on
    chip exactly where that fits and keeps as many blocks resident on an
    SM as device memory does."""
    lifted = _lifted(k, n)
    layout = lg.layered_grad_layout(lifted)
    z, n_e, n_c = lifted._z, len(lifted._edges), lifted._n_col_blocks
    assert (layout.gc_on_chip, layout.threads) == CODES[k, n][1]
    base = 4 * (layout.plan.size + 2 * n_c * z)
    assert layout.smem_bytes == base + 4 * n_e * z * layout.gc_on_chip
    assert layout.smem_bytes <= SMEM_PER_BLOCK
    assert layout.threads % z == 0
    assert layout.threads <= lg.K5LB_MAX_THREADS
    rows = [lifted._row_edges.get(r, []) for r in range(lifted._n_row_blocks)]
    steps = _row_steps(lifted, rows)
    assert layout.steps == steps
    assert layout.threads // z == min(
        max(b - a for a, b in steps), lg.K5LB_MAX_THREADS // z)
    np.testing.assert_array_equal(layout.plan,
                                  layered_bp_layout(lifted).plan)
    with_gc = base + 4 * n_e * z
    assert layout.gc_on_chip == (
        with_gc <= SMEM_PER_BLOCK
        and _resident(with_gc, layout.threads) >= _resident(
            base, layout.threads))


def _resident(smem, threads):
    """Blocks of K5Lb resident on one SM, by their shared memory and by
    the warps an SM holds at its registers."""
    return min(SMEM_PER_SM // (smem + 1024),
               lg.K5LB_SM_WARPS // -(-threads // 32))


def test_layered_grad_layout_largest_code():
    """BG1 at Z=384 with 68 columns (k=8448, n=25344): the posterior and
    dL/dpost take 209 KB, so dL/dc2v does not fit beside them; it lives
    in device memory with v2c, one block of 384 lanes per codeword."""
    lifted = _lifted(8448, 25344)
    layout = lg.layered_grad_layout(lifted)
    assert layout.threads == 384 and not layout.gc_on_chip
    assert layout.smem_bytes == 4 * (layout.plan.size + 2 * 68 * 384)
    assert layout.smem_bytes <= SMEM_PER_BLOCK < \
        layout.smem_bytes + 4 * len(lifted._edges) * 384


def test_grad_layouts_refuse_what_no_layout_takes():
    """A code whose state no layout holds (K5b: no cluster of 8 blocks;
    K5Lb: no block), an edge mask that is not one cyclic range and a row
    degree with no check-node case raise ValueError in both planners."""
    wide = copy.copy(_lifted(6144, 12288))
    wide._z = 3000  # 2 x 46 x 3000 x 4 B of posterior and dL/dpost
    with pytest.raises(ValueError, match="no K5b layout takes this code"):
        lg.flooding_grad_layout(wide)
    with pytest.raises(ValueError, match="no K5Lb layout takes this code"):
        lg.layered_grad_layout(wide)
    small = _lifted(100, 200)
    split = copy.copy(small)
    split._edge_mask = list(small._edge_mask)
    split._edge_mask[0] = np.tile([1., 0.], small._z // 2)
    dense = copy.copy(small)
    dense._row_edges = {0: list(range(12))}  # no 5G row has degree 12
    for plan in (lg.flooding_grad_layout, lg.layered_grad_layout):
        with pytest.raises(ValueError, match="cyclic range"):
            plan(split)
        with pytest.raises(ValueError, match="row degree"):
            plan(dense)


def test_reverse_wrappers_refuse_cpu_tensors():
    """The backward kernels' wrappers take CUDA tensors only: on the CPU
    the plain reverse is the path (``LiftedBPFunction``)."""
    lifted = _lifted(100, 200)
    x = torch.zeros(2, lifted._num_vns)
    tape = torch.zeros(2, len(lifted._edges), 2, lifted._z)
    tape_m = torch.zeros(2, lifted._n_col_blocks, 2, lifted._z)
    with pytest.raises(ValueError, match="CUDA"):
        lg.flooding_reverse_cuda(lifted, x, tape, x)
    with pytest.raises(ValueError, match="CUDA"):
        lg.layered_reverse_cuda(lifted, x, tape_m, tape, x)


def _emulate_k5b(lifted, layout, llr_int, tape, g_marg):
    """K5b's schedule on the CPU from its plan alone (and the code's Z,
    clipping and CN rule): every lane of a unit at once, the slabs' slots
    keyed by their plan id, the register edges' two slots in lists, the
    VN lanes' dL/dllr accumulated as the kernel does. Returns dL/dllr."""
    arr = _k1_arrays(lifted, layout)
    z, n_cols = lifted._z, lifted._n_col_blocks
    clip = lifted._llr_max
    n_e = len(lifted._edges)
    batch, num_iter = llr_int.shape[0], tape.shape[0]
    pad = n_cols * z - lifted._num_vns
    llr = F.pad(llr_int, (0, pad)).reshape(batch, n_cols, z)
    gm = F.pad(g_marg, (0, pad)).reshape(batch, n_cols, z)
    masks = list(lifted.masks)
    row_ptr, col_ptr = arr["row_ptr"], arr["col_ptr"]
    slab_c, slab_g = {}, {}
    n_reg = layout.n_reg_rows
    reg_gv = [torch.zeros(batch, z)] * n_reg
    reg_gc = [None] * n_reg
    gl = [None] * n_cols

    def roll(x, s):
        return torch.roll(x, int(s), -1)

    def row_eids(r):
        return list(range(row_ptr[r], row_ptr[r + 1]))

    def forward(r, reg_pos, v2c):
        eids = row_eids(r)
        c2v = _lifted_cn_phase(v2c, masks, {r: eids}, n_e, clip,
                               lifted._offset, lifted._cn_mode,
                               lifted._edge_full)
        for k, e in enumerate(eids):
            if k != reg_pos:
                slab_c[int(arr["row_slot"][e])] = c2v[e]
        return c2v[eids[reg_pos]] if reg_pos >= 0 else None

    def adjoint(r, reg_pos, reg_g, v2c):
        eids = row_eids(r)
        g_c2v = [None] * n_e
        for k, e in enumerate(eids):
            g_c2v[e] = reg_g if k == reg_pos else \
                slab_c[int(arr["row_slot"][e])]
        g = lg._row_adjoint(v2c, g_c2v, masks, eids, lifted._edge_full,
                            clip, lifted._offset, lifted._cn_mode)
        for k, e in enumerate(eids):
            if k != reg_pos:
                slab_g[int(arr["row_slot"][e])] = g[k]
        return g[reg_pos] if reg_pos >= 0 else None

    def accumulate(c, gt, last):
        gl[c] = (torch.zeros_like(gt) if last else gl[c]) + gt

    for it in range(num_iter - 1, -1, -1):
        last = it == num_iter - 1
        v2c = list(tape[it])
        for i, r in enumerate(arr["reg_rows"]):
            c2v = roll(forward(r, arr["reg_pos"][i], v2c),
                       arr["reg_shift"][i])
            c = arr["reg_col"][i]
            tot = llr[:, c] + c2v
            gv = roll(reg_gv[i], arr["reg_shift"][i])
            h = gv * lg._d_clip(tot - c2v, clip)
            gt = gm[:, c] * lg._d_clip(tot, clip) if last else h
            reg_gc[i] = roll(gt - (0. if last else h), -arr["reg_shift"][i])
            accumulate(c, gt, last)
        for r in arr["plain_rows"]:
            forward(r, -1, v2c)
        for c in arr["vn_cols"]:
            ps = range(col_ptr[c], col_ptr[c + 1])
            sid = [int(arr["col_slot"][p]) for p in ps]
            sh = [arr["col_shift"][p] for p in ps]
            xs = [roll(slab_c[s], t) for s, t in zip(sid, sh)]
            tot = llr[:, c]
            for x in xs:
                tot = tot + x
            hs = [None if last else roll(slab_g[s], t)
                  * lg._d_clip(tot - x, clip) for s, t, x in zip(sid, sh, xs)]
            gt = gm[:, c] * lg._d_clip(tot, clip) if last else \
                torch.zeros_like(tot)
            if not last:
                for h in hs:
                    gt = gt + h
            for s, t, h in zip(sid, sh, hs):
                slab_c[s] = roll(gt if last else gt - h, -t)
            accumulate(c, gt, last)
        for i, r in enumerate(arr["reg_rows"]):
            reg_gv[i] = adjoint(r, arr["reg_pos"][i], reg_gc[i], v2c)
        for r in arr["plain_rows"]:
            adjoint(r, -1, None, v2c)
    for i, c in enumerate(arr["reg_col"]):
        gl[c] = gl[c] + lg._d_clip(llr[:, c], clip) * roll(
            reg_gv[i], arr["reg_shift"][i])
    for c in arr["vn_cols"]:
        ps = range(col_ptr[c], col_ptr[c + 1])
        if not ps:
            continue
        acc = 0.
        for p in ps:
            acc = acc + roll(slab_g[int(arr["col_slot"][p])],
                             arr["col_shift"][p])
        gl[c] = gl[c] + lg._d_clip(llr[:, c], clip) * acc
    return torch.stack(gl, 1).reshape(batch, -1)[:, :lifted._num_vns]


@pytest.mark.parametrize("cn_update,num_iter", [("boxplus", 3),
                                                ("minsum", 2),
                                                ("boxplus", 1)])
@pytest.mark.parametrize("k,n", [(100, 200), (1024, 2048)])
def test_k5b_schedule_matches_plain_reverse(k, n, cn_update, num_iter):
    """K5b's schedule, emulated from its layout's plan (register edges'
    VN reverse with their row's forward, the slabs' slot ids, the staged
    rows' order), gives the plain reverse's dL/dllr within 1e-6 of its
    largest value (the same terms; the emulation sums a column's terms
    in the plain version's order)."""
    enc = LDPC5GEncoder(k, n)
    lifted = LDPC5GDecoder(enc, cn_update=cn_update).lifted
    rng = np.random.default_rng(k + num_iter)
    llr = torch.tensor(3 * rng.normal(size=(2, lifted._num_vns)) + 1,
                       dtype=torch.float32)
    g = torch.tensor(rng.normal(size=llr.shape), dtype=torch.float32)
    _, tape = lg.flooding_tape_forward(lifted, llr, num_iter)
    want = lg.flooding_reverse(lifted, llr, tape, g)
    got = _emulate_k5b(lifted, lg.flooding_grad_layout(lifted), llr, tape, g)
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale)
