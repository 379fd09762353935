"""The layouts of the gradient's backward kernels K5b and K5Lb
(``flooding_grad_layout`` and ``layered_grad_layout`` in
``sionna_tpu_torch/phy/fec/ldpc/lifted_grad.py``), plain Python planners
that run here, for every code that ``chip_smoke.py``'s phases 36-37 and
``tools/kernel_compare.py`` run on the card: what each block holds fits
its shared memory, every edge lane has one owner, the register edges are
the degree-1 columns the kernel takes them for, and a code no layout
takes raises. K5b's schedule is also run here from its plan alone
(``_emulate_k5b``) and held to the plain reverse, and the tape kernels'
schedules, K1's and K3's with the tape stores, from K1's and K3's plans
(``_emulate_k5f``, ``_emulate_k5lf``), held to the plain tape forward
bit for bit."""

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


def _plan_masks(ranges, z):
    """Per row position, the lane mask of its cyclic active-lane range
    (lo, length) as the kernels test it, and whether all lanes are on."""
    lanes = torch.arange(z)
    masks = [((lanes - int(lo)) % z < int(n)).to(torch.float32)
             for lo, n in ranges]
    return masks, [bool(m.all()) for m in masks]


def _emulate_k5f(lifted, llr_int, num_iter):
    """K5f's schedule on the CPU from K1's plan alone (and the code's Z,
    clipping and CN rule): K1's init of the slots from the VN side, then
    per iteration the CN units of the rows with a register edge (each with
    its degree-1 column's VN update), of the other rows, and the VN phase,
    every lane of a unit at once; each CN unit stores the v2c it reads to
    the tape at its row position. Returns (marginals, tape, the stores of
    each tape row)."""
    layout = lifted.k1_layout()
    arr = _k1_arrays(lifted, layout)
    z, n_cols, n_e = lifted._z, lifted._n_col_blocks, len(lifted._edges)
    clip = lifted._llr_max
    batch = llr_int.shape[0]
    llr = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).reshape(
        batch, n_cols, z)
    row_ptr, col_ptr = arr["row_ptr"], arr["col_ptr"]
    masks, full = _plan_masks([(r & 0xffff, r >> 16)
                               for r in arr["row_range"]], z)
    tape = torch.full((num_iter, n_e, batch, z), float("nan"))
    stores = torch.zeros(num_iter, n_e, dtype=torch.int64)
    out = llr.clone()  # 0 iterations: the LLRs

    def roll(x, s):
        return torch.roll(x, int(s), -1)

    def clamp(x):
        return torch.clamp(x, -clip, clip)

    slots = {}  # CN-aligned v2c, then c2v, by plan slot id
    for c in arr["vn_cols"]:
        for p in range(col_ptr[c], col_ptr[c + 1]):
            slots[int(arr["col_slot"][p])] = roll(clamp(llr[:, c]),
                                                  -arr["col_shift"][p])
    reg = [roll(clamp(llr[:, c]), -s)
           for c, s in zip(arr["reg_col"], arr["reg_shift"])]

    def cn_unit(t, r, reg_pos, reg_v2c):
        eids = list(range(row_ptr[r], row_ptr[r + 1]))
        v2c = [None] * n_e
        for k, p in enumerate(eids):
            v2c[p] = reg_v2c if k == reg_pos else \
                slots[int(arr["row_slot"][p])]
            tape[t, p] = v2c[p]
            stores[t, p] += 1
        c2v = _lifted_cn_phase(v2c, masks, {r: eids}, n_e, clip,
                               lifted._offset, lifted._cn_mode, full)
        for k, p in enumerate(eids):
            if k != reg_pos:
                slots[int(arr["row_slot"][p])] = c2v[p]
        return c2v[eids[reg_pos]] if reg_pos >= 0 else None

    for t in range(num_iter):
        last = t == num_iter - 1
        for i, r in enumerate(arr["reg_rows"]):
            s, c = arr["reg_shift"][i], arr["reg_col"][i]
            x = roll(cn_unit(t, r, arr["reg_pos"][i], reg[i]), s)
            tot = llr[:, c] + x
            if last:
                out[:, c] = clamp(tot)
            reg[i] = roll(clamp(tot - x), -s)
        for r in arr["plain_rows"]:
            cn_unit(t, r, -1, None)
        for c in arr["vn_cols"]:
            ps = range(col_ptr[c], col_ptr[c + 1])
            xs = [roll(slots[int(arr["col_slot"][p])], arr["col_shift"][p])
                  for p in ps]
            tot = llr[:, c]
            for x in xs:
                tot = tot + x
            if last:
                out[:, c] = clamp(tot)
            for p, x in zip(ps, xs):
                slots[int(arr["col_slot"][p])] = roll(clamp(tot - x),
                                                      -arr["col_shift"][p])
    return out.reshape(batch, -1)[:, :lifted._num_vns], tape, stores


def _k3_arrays(lifted, layout):
    """K3's plan by name: the int4 edge records by row position, the step
    pointers into the rows and the row pointers into the positions."""
    plan = layout.plan.astype(np.int64)
    n_e, n_rows = len(lifted._edges), lifted._n_row_blocks
    edge = plan[plan[0]:plan[0] + 4 * n_e].reshape(n_e, 4)
    step_ptr = plan[plan[1]:plan[1] + len(layout.steps) + 1]
    row_ptr = plan[plan[2]:plan[2] + n_rows + 1]
    return edge, step_ptr, row_ptr


def _emulate_k5lf(lifted, llr_int, num_iter):
    """K5Lf's schedule on the CPU from K3's f32 layout and plan alone:
    the lanes split into the layout's runs, one per block of the cluster;
    when an iteration starts, each block stores its run of every column
    of the posterior to tape_m; then the row steps, in each of which each
    block takes its lanes of the step's edges (phase A: v2c from the
    posterior and the slot's c2v_old, which goes to tape_c at the edge's
    row position), the rows' check nodes (B) and the updates of the
    posterior and the slots (C). Returns (marginals, tape_m, tape_c, the
    stores of each element of tape_m and of tape_c)."""
    layout = layered_bp_layout(lifted)
    edge, step_ptr, row_ptr = _k3_arrays(lifted, layout)
    z, n_cols, n_e = lifted._z, lifted._n_col_blocks, len(lifted._edges)
    batch = llr_int.shape[0]
    col, shift = edge[:, 0] // z, edge[:, 0] % z
    assert (edge[:, 1] == z - shift).all()
    masks, full = _plan_masks(edge[:, 2:], z)
    post = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).reshape(
        batch, n_cols, z).clone()
    c2v = torch.zeros(n_e, batch, z)
    tape_m = torch.full((num_iter, n_cols, batch, z), float("nan"))
    tape_c = torch.full((num_iter, n_e, batch, z), float("nan"))
    stores_m = torch.zeros(num_iter, n_cols, z, dtype=torch.int64)
    stores_c = torch.zeros(num_iter, n_e, z, dtype=torch.int64)
    runs = [torch.arange(b * layout.lanes, min(z, (b + 1) * layout.lanes))
            for b in range(layout.cluster)]
    for t in range(num_iter):
        for gi in runs:
            tape_m[t][:, :, gi] = post[:, :, gi].transpose(0, 1)
            stores_m[t][:, gi] += 1
        for s in range(len(layout.steps)):
            r0, r1 = step_ptr[s], step_ptr[s + 1]
            for gi in runs:
                lane_masks = [m[gi] for m in masks]
                v2c, old, vn = [None] * n_e, {}, {}
                for p in range(row_ptr[r0], row_ptr[r1]):
                    vn[p] = (gi + int(shift[p])) % z
                    old[p] = c2v[p][:, gi]
                    tape_c[t, p][:, gi] = old[p]
                    stores_c[t, p, gi] += 1
                    v2c[p] = post[:, col[p]][:, vn[p]] - old[p]
                for r in range(r0, r1):
                    eids = list(range(row_ptr[r], row_ptr[r + 1]))
                    new = _lifted_cn_phase(
                        v2c, lane_masks, {r: eids}, n_e, lifted._llr_max,
                        lifted._offset, lifted._cn_mode, full)
                    for p in eids:
                        post[:, col[p], vn[p]] = post[:, col[p], vn[p]] + (
                            new[p] - old[p])
                        c2v[p][:, gi] = new[p]
    marg = post.reshape(batch, -1)[:, :lifted._num_vns]
    return marg, tape_m, tape_c, stores_m, stores_c


def _grad_llrs(lifted, batch, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(3 * rng.normal(size=(batch, lifted._num_vns)) + 1,
                        dtype=torch.float32)


@pytest.mark.parametrize("cn_update", ["boxplus", "minsum"])
@pytest.mark.parametrize("k,n", [(100, 200), (1024, 2048)])
def test_k5f_schedule_matches_plain_tape_forward(k, n, cn_update):
    """K5f runs K1's schedule from K1's plan and stores each v2c a CN unit
    reads at its row position: the marginals and the tape of the plain
    tape forward bit for bit, every tape row stored once per iteration."""
    lifted = LDPC5GDecoder(LDPC5GEncoder(k, n), cn_update=cn_update).lifted
    llr = _grad_llrs(lifted, 2, k)
    for num_iter in (0, 3):
        marg, tape, stores = _emulate_k5f(lifted, llr, num_iter)
        want_marg, want_tape = lg.flooding_tape_forward(lifted, llr,
                                                        num_iter)
        assert (stores == 1).all()
        assert torch.equal(marg, want_marg)
        assert torch.equal(tape, want_tape)


@pytest.mark.parametrize("cn_update", ["boxplus", "minsum"])
@pytest.mark.parametrize("k,n", [(100, 200), (1024, 2048), (6144, 12288)])
def test_k5lf_schedule_matches_plain_tape_forward(k, n, cn_update):
    """K5Lf runs K3's row steps from K3's f32 layout and plan, each block
    of the cluster on its lane run (n=12288: 2 blocks of 144 lanes): every
    element of tape_m and tape_c is stored once, and the marginals and
    both tapes are the plain tape forward's bit for bit."""
    lifted = LDPC5GDecoder(LDPC5GEncoder(k, n), cn_update=cn_update).lifted
    assert layered_bp_layout(lifted).cluster == (2 if n == 12288 else 1)
    llr = _grad_llrs(lifted, 2, n)
    for num_iter in (0, 2):
        marg, tape_m, tape_c, stores_m, stores_c = _emulate_k5lf(
            lifted, llr, num_iter)
        want = lg.layered_tape_forward(lifted, llr, num_iter)
        assert (stores_m == 1).all() and (stores_c == 1).all()
        for got, ref in zip((marg, tape_m, tape_c), want):
            assert torch.equal(got, ref)
