"""The layout of the layered kernel K3 (csrc/ldpc_layered_bp.cu) on the
CPU: the plan it reads, held against the decoder's tables, the codes it
takes and refuses, and K3's schedule (lane split over a cluster with a
posterior replica per block, three phases per step of rows that share no
column, signed check-node scratch, cyclic ranges in place of the masks)
run from that plan against the plain layered decode, which the tests of
tests/test_torch_ldpc.py hold against the JAX package's. The kernel
itself runs only where a card is present (chip_smoke.py)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc.decoding import (K3_MAX_CLUSTER,
                                                    K3_MAX_THREADS,
                                                    K3_PLAN_ARRAYS,
                                                    K3_SM_THREADS,
                                                    SMEM_PER_BLOCK,
                                                    SMEM_PER_SM,
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


def _lifted(k, n, cn="boxplus"):
    return LDPC5GDecoder(LDPC5GEncoder(k, n), cn_update=cn,
                         cn_schedule="layered", engine="pallas").lifted


# (k, n): {storage: (cluster, lanes per block, shared-memory bytes,
# threads per block)}, and the row steps. Per codeword the flagship
# (Z=288, 46 columns, 210 edges, rows of degree up to 19) holds 52,992 B
# of posterior and 241,920 B of f32 c2v (120,960 B in bf16), plus a
# 19-row check-node scratch, the 896-int plan and two 8-byte mbarriers:
# one block in bf16; two in f32, each with a replica of the posterior
# and half the c2v lanes. BG1 at Z=384 needs three blocks in f32, two in
# bf16. Its 24 rows run in 21 steps: rows 16-17, 20-21 and 22-23 share
# no column. The largest 5G code, BG1 at Z=384 and rate 1/3 (68 columns,
# 316 edges, 46 rows in 32 steps), needs five blocks in f32 (104,448 B
# of posterior replica each), three in bf16.
K3_CODES = {
    (100, 200): ({None: (1, 18, 7248, 18), torch.bfloat16: (1, 18, 5160, 18)},
                 8),
    (1024, 2048): ({None: (1, 104, 46736, 104),
                    torch.bfloat16: (1, 104, 30720, 104)}, 12),
    (6144, 12288): ({None: (2, 144, 188_496, 576),
                     torch.bfloat16: (1, 288, 199_440, 576)}, 21),
    (8448, 16896): ({None: (3, 128, 191_504, 512),
                     torch.bfloat16: (2, 192, 169_488, 576)}, 21),
    (8448, 25344): ({None: (5, 77, 213_052, 539),
                     torch.bfloat16: (3, 128, 200_496, 512)}, 32),
}


def _plan_arrays(lifted, layout):
    """The plan's arrays by name, read back through its header; the
    edge records as [edges, 4]."""
    plan = layout.plan.astype(np.int64)
    sizes = [4 * len(lifted._edges), len(layout.steps) + 1,
             lifted._n_row_blocks + 1]
    out = {}
    for i, (name, size) in enumerate(zip(K3_PLAN_ARRAYS, sizes,
                                         strict=True)):
        assert plan[i] % 4 == 0  # every array 16-byte aligned
        out[name] = plan[plan[i]:plan[i] + size]
    assert plan[0] == 4  # three offsets, padded
    assert -(-(plan[len(sizes) - 1] + sizes[-1]) // 4) * 4 == plan.size
    out["edge"] = out["edge"].reshape(-1, 4)
    return out


@pytest.mark.parametrize("storage", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n", list(K3_CODES))
def test_k3_layout_matches_decoder_tables(k, n, storage):
    lifted = _lifted(k, n)
    layout = layered_bp_layout(lifted, storage)
    z, edges = lifted._z, lifted._edges
    n_cols = lifted._n_col_blocks
    by_storage, n_steps = K3_CODES[(k, n)]
    cluster, lanes, smem, threads = by_storage[storage]
    assert (layout.cluster, layout.lanes, layout.smem_bytes,
            layout.threads, len(layout.steps)) == \
        (cluster, lanes, smem, threads, n_steps)
    # row steps: the rows in order, consecutive rows sharing no column,
    # each step as long as it can be
    rows = [lifted._row_edges.get(r, []) for r in range(lifted._n_row_blocks)]
    cols = [{edges[e][1] for e in r} for r in rows]
    assert [r for a, b in layout.steps for r in range(a, b)] == \
        list(range(len(rows)))
    for a, b in layout.steps:
        step_cols = [c for r in range(a, b) for c in cols[r]]
        assert len(step_cols) == len(set(step_cols))
        if b < len(rows):
            assert cols[b] & set(step_cols)
    step_degree = max(sum(len(rows[r]) for r in range(a, b))
                      for a, b in layout.steps)
    msg_bytes = 4 if storage is None else 2
    assert layout.step_degree == step_degree
    assert layout.smem_bytes == 16 + (n_cols * z + step_degree * lanes
                                      + layout.plan.size) * 4 + \
        len(edges) * lanes * msg_bytes <= SMEM_PER_BLOCK
    # the fewest blocks: one fewer would not fit, and every block owns
    # at least one lane
    assert (cluster - 1) * lanes < z <= cluster * lanes
    if cluster > 1:
        fewer = -(-z // (cluster - 1))
        assert 16 + (n_cols * z + step_degree * fewer
                     + layout.plan.size) * 4 + \
            len(edges) * fewer * msg_bytes > SMEM_PER_BLOCK
    # threads: m per lane, the blocks an SM holds within K3_SM_THREADS
    per_sm = SMEM_PER_SM // (smem + 1024)
    assert threads % lanes == 0 and threads <= K3_MAX_THREADS
    assert threads // lanes == max(1, min(step_degree,
                                          K3_SM_THREADS // (per_sm * lanes)))
    # slots: each edge's position in row order, one per edge
    rows = lifted.row_edge_ids.numpy()
    assert [layout.slots[e] for e in rows] == list(range(len(edges)))
    # the plan: the decoder's row pointers; per edge in row order its
    # posterior offset and wrap lane, and its cyclic active-lane range,
    # which is its row of masks
    arr = _plan_arrays(lifted, layout)
    assert list(arr["step_ptr"]) == [a for a, _ in layout.steps] + \
        [lifted._n_row_blocks]
    np.testing.assert_array_equal(arr["row_ptr"], lifted.row_ptr.numpy())
    masks = lifted.masks.numpy()
    lanes_z = np.arange(z)
    for p, e in enumerate(rows):
        off, wrap, lo, length = arr["edge"][p]
        _, c, shift = edges[e]
        # the posterior index of each lane: c * z + (lane + shift) mod z
        np.testing.assert_array_equal(
            off + lanes_z - np.where(lanes_z >= wrap, z, 0),
            c * z + (lanes_z + shift) % z)
        assert (lo, length) == layout.ranges[e]
        np.testing.assert_array_equal(
            ((lanes_z - lo) % z < length).astype(np.float32), masks[e])
    # the plan is the same for both storage types; the layout is cached
    np.testing.assert_array_equal(
        layout.plan, layered_bp_layout(lifted, None).plan)
    assert lifted.k3_layout(storage) is lifted.k3_layout(storage)
    assert lifted.k3_layout(storage)[:-1] == layout[:-1]


def test_k3_layout_refuses_what_no_layout_takes():
    lifted = _lifted(6144, 12288)
    wide = copy.copy(lifted)
    wide._z = 3000  # a 552 KB posterior replica alone
    with pytest.raises(ValueError, match="no K3 layout takes this code"):
        layered_bp_layout(wide)
    small = _lifted(100, 200)
    split = copy.copy(small)
    split._edge_mask = list(small._edge_mask)
    split._edge_mask[0] = np.tile([1., 0.], small._z // 2)
    with pytest.raises(ValueError, match="cyclic range"):
        layered_bp_layout(split)
    dense = copy.copy(small)
    dense._row_edges = {0: list(range(12))}  # no 5G row has degree 12
    with pytest.raises(ValueError, match="row degree"):
        layered_bp_layout(dense)
    with pytest.raises(ValueError, match="storage_dtype"):
        layered_bp_layout(small, torch.float16)
    assert K3_MAX_CLUSTER >= 5


# One code of each 5G lifting set (i_LS 0-7, Z = a * 2^j for a = 2, 3,
# 5, 7, 9, 11, 13, 15) of each base graph, the smallest the encoder
# lifts with it: (k, n, Z).
LIFTING_SET_CODES = {
    ("bg1", 0): (331, 414, 16), ("bg1", 1): (488, 610, 24),
    ("bg1", 2): (397, 496, 20), ("bg1", 3): (293, 366, 14),
    ("bg1", 4): (353, 441, 18), ("bg1", 5): (448, 560, 22),
    ("bg1", 6): (536, 670, 26), ("bg1", 7): (309, 386, 15),
    ("bg2", 0): (20, 40, 4), ("bg2", 1): (31, 62, 6),
    ("bg2", 2): (25, 50, 5), ("bg2", 3): (37, 74, 7),
    ("bg2", 4): (49, 98, 9), ("bg2", 5): (61, 122, 11),
    ("bg2", 6): (73, 146, 13), ("bg2", 7): (85, 170, 15),
}


@pytest.mark.parametrize("bg,i_ls", list(LIFTING_SET_CODES))
def test_k3_layout_takes_every_lifting_set(bg, i_ls):
    """Every code the first K3 took (any row degree up to 32, any Z) has
    a layout: the 5G rows' degrees are check-node cases, the masks cyclic
    ranges."""
    k, n, z = LIFTING_SET_CODES[(bg, i_ls)]
    enc = LDPC5GEncoder(k, n)
    assert (enc._bg, enc._i_ls, enc.z) == (bg, i_ls, z)
    lifted = _lifted(k, n)
    for storage in (None, torch.bfloat16):
        layout = layered_bp_layout(lifted, storage)
        assert layout.cluster == 1 and layout.lanes == z


# The largest code of each lifting set of each base graph: the set's
# largest Z, all information columns (k = 22 Z for BG1, 10 Z for BG2) at
# the lowest rate (1/3, 1/5), so that no column is pruned: 68 columns and
# 316 edges (BG1), 52 and 197 (BG2). (Z, f32 cluster, bf16 cluster.)
LARGEST_CODES = {
    ("bg1", 0): (256, 3, 2), ("bg1", 1): (384, 5, 3),
    ("bg1", 2): (320, 4, 2), ("bg1", 3): (224, 2, 1),
    ("bg1", 4): (288, 3, 2), ("bg1", 5): (352, 4, 2),
    ("bg1", 6): (208, 2, 1), ("bg1", 7): (240, 2, 2),
    ("bg2", 0): (256, 2, 1), ("bg2", 1): (384, 3, 2),
    ("bg2", 2): (320, 2, 1), ("bg2", 3): (224, 2, 1),
    ("bg2", 4): (288, 2, 1), ("bg2", 5): (352, 2, 1),
    ("bg2", 6): (208, 1, 1), ("bg2", 7): (240, 2, 1),
}


@pytest.mark.parametrize("bg,i_ls", list(LARGEST_CODES))
def test_k3_layout_takes_the_largest_code_of_every_lifting_set(bg, i_ls):
    """The first K3 took every 5G code (its posterior, at most 104,448 B,
    in shared memory, its c2v in device memory); the largest code of each
    lifting set has a layout too, within the shared memory of its cluster,
    and the plan does not depend on the storage type."""
    z, f32_blocks, bf16_blocks = LARGEST_CODES[(bg, i_ls)]
    k, n = (22 * z, 66 * z) if bg == "bg1" else (10 * z, 50 * z)
    enc = LDPC5GEncoder(k, n)
    assert (enc._bg, enc._i_ls, enc.z) == (bg, i_ls, z)
    lifted = _lifted(k, n)
    assert (lifted._n_col_blocks, len(lifted._edges)) == \
        ((68, 316) if bg == "bg1" else (52, 197))
    f32, bf16 = (layered_bp_layout(lifted, s) for s in (None, torch.bfloat16))
    assert (f32.cluster, bf16.cluster) == (f32_blocks, bf16_blocks)
    for layout in (f32, bf16):
        assert layout.smem_bytes <= SMEM_PER_BLOCK
        assert layout.cluster <= K3_MAX_CLUSTER
    np.testing.assert_array_equal(f32.plan, bf16.plan)
    np.testing.assert_array_equal(lifted.k3_plan("cpu").numpy(), f32.plan)


def _emulate_k3(lifted, layout, llr_int, num_iter, storage_dtype=None):
    """K3's schedule on the CPU, from the plan alone (and the code's Z,
    clipping, offset and CN rule): block b of the cluster owns lanes
    [b L, b L + L) of every c2v slot and holds a replica of the
    posterior; the work of lane i reads the posterior from its block's
    replica and writes it to every replica; per row step (rows that share
    no column), phase A
    writes each (edge, lane)'s signed check-node input to the block's
    scratch, phase B turns it per row and lane into the signed
    extrinsics, phase C updates the posterior and the c2v slot. Each
    phase's transcendental functions run on all lanes at once ([batch,
    Z], as the plain decode lays them out); the other operations are
    exact."""
    arr = _plan_arrays(lifted, layout)
    z, n_lanes = lifted._z, layout.lanes
    n_cols = lifted._n_col_blocks
    clip, offset = lifted._llr_max, lifted._offset
    boxplus = lifted._cn_mode == "boxplus"
    batch = llr_int.shape[0]
    blocks = range(layout.cluster)
    own = [torch.arange(b * n_lanes, min((b + 1) * n_lanes, z))
           for b in blocks]
    llr = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).reshape(
        batch, n_cols, z)

    def store(x):
        return x if storage_dtype is None else \
            x.to(storage_dtype).to(x.dtype)

    post = [llr.clone() for b in blocks]
    c2v = [torch.zeros(batch, len(lifted._edges), len(own[b]))
           for b in blocks]
    scratch = [torch.zeros(batch, layout.step_degree, len(own[b]))
               for b in blocks]
    one, big = torch.tensor(1.), torch.tensor(1e30)
    hi = torch.tensor(1 - 1e-7, dtype=torch.float32)
    lanes = torch.arange(z)

    def post_read(c, v):
        """Lane i reads posterior lane v[i] of column c in the replica of
        its own block."""
        return all_lanes([post[b][:, c, v[own[b]]] for b in blocks])

    def post_add(c, v, delta):
        """Lane i adds delta[i] to posterior lane v[i] of column c in its
        block's replica and pushes the sum to the other replicas."""
        for b in blocks:
            new = post[b][:, c, v[own[b]]] + delta[:, own[b]]
            for replica in post:
                replica[:, c, v[own[b]]] = new

    def all_lanes(parts):
        return torch.cat(parts, -1)

    def edge(p):
        """Posterior column and lane of each lane's item, and its
        activity, from the edge's record."""
        off, wrap, lo, length = (int(x) for x in arr["edge"][p])
        j = off + lanes - torch.where(lanes >= wrap, z, 0)
        active = lanes - lo + torch.where(lanes < lo, z, 0) < length
        return off // z, j - off // z * z, active

    def cn_lane(x):
        """Phase B of one row for a block's lanes: its signed inputs x
        [batch, d, lanes] -> the signed extrinsics."""
        d = x.shape[1]
        val = [torch.abs(x[:, k]) for k in range(d)]
        neg = [torch.signbit(x[:, k]) for k in range(d)]
        tot = sum(n.to(torch.int32) for n in neg) % 2 == 1
        exts = []
        if boxplus:
            bwd = [None] * d
            bwd[d - 1] = val[d - 1]
            for k in range(d - 2, -1, -1):
                bwd[k] = bwd[k + 1] * val[k]
            fwd = None
            for k in range(d):
                if d == 1:
                    ext = hi.expand_as(val[0])
                elif k == 0:
                    ext = torch.minimum(bwd[1], hi)
                elif k == d - 1:
                    ext = torch.minimum(fwd, hi)
                else:
                    ext = torch.minimum(fwd * bwd[k + 1], hi)
                fwd = val[0] if k == 0 else fwd * val[k]
                exts.append(ext)
        else:
            min1 = val[0]
            for v in val[1:]:
                min1 = torch.minimum(min1, v)
            min2 = big
            for v in val:
                min2 = torch.minimum(min2, torch.where(v > min1, v, big))
            n_min = sum((v == min1).to(torch.int32) for v in val)
            for v in val:
                ext = torch.where((v == min1) & (n_min == 1), min2, min1)
                if offset > 0.:
                    ext = torch.clamp(ext - offset, min=0.)
                exts.append(ext)
        return torch.stack([torch.where(tot ^ n, -e, e)
                            for n, e in zip(neg, exts)], 1)

    step_ptr, row_ptr = arr["step_ptr"], arr["row_ptr"]
    for _ in range(num_iter):
        for s in range(len(step_ptr) - 1):
            r0, r1 = int(step_ptr[s]), int(step_ptr[s + 1])
            p0, d = int(row_ptr[r0]), int(row_ptr[r1] - row_ptr[r0])
            for k in range(d):  # A
                c, v, active = edge(p0 + k)
                m = post_read(c, v) - all_lanes([x[:, p0 + k] for x in c2v])
                a = torch.abs(m)
                t = torch.tanh(a / 2) if boxplus else a
                t = torch.where(active, t, one if boxplus else big)
                x = torch.where(active & (m < 0), -t, t)
                for b in blocks:
                    scratch[b][:, k] = x[:, own[b]]
            for b in blocks:  # B, each row of the step
                for r in range(r0, r1):
                    q0, q1 = int(row_ptr[r]) - p0, int(row_ptr[r + 1]) - p0
                    if q1 > q0:
                        scratch[b][:, q0:q1] = cn_lane(scratch[b][:, q0:q1])
            for k in range(d):  # C
                p = p0 + k
                c, v, active = edge(p)
                x = all_lanes([s[:, k] for s in scratch])
                e = torch.abs(x)
                mag = torch.log1p(e) - torch.log1p(-e) if boxplus else e
                new = torch.where(torch.signbit(x), -one, one) * \
                    torch.clamp(mag, max=clip) * active.to(torch.float32)
                post_add(c, v, new - all_lanes([s[:, p] for s in c2v]))
                for b in blocks:
                    c2v[b][:, p] = store(new[:, own[b]])
    for replica in post[1:]:
        assert torch.equal(replica, post[0])
    out = torch.cat([post[b][:, :, own[b]] for b in blocks], -1)
    return out.reshape(batch, -1)[:, :lifted._num_vns]


@pytest.mark.parametrize("storage", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n,cn", [
    (100, 200, "boxplus"),
    (100, 200, "minsum"),
    (1024, 2048, "offset-minsum"),
    (6144, 12288, "boxplus"),
    (8448, 16896, "minsum"),
    (8448, 25344, "offset-minsum"),
])
def test_k3_schedule_from_plan_matches_plain(k, n, cn, storage):
    """K3's schedule, run from its plan on the CPU, gives the plain
    layered decode's marginals exactly after 0, 1 and 2 iterations: the
    lane split of the cluster layout (n=12288 in f32, n=16896), the
    check-node scratch with the signs in its sign bits, the per-lane
    products, the cyclic ranges in place of the masks, bf16 c2v; the
    largest code (n=25344) in five blocks (f32) and three (bf16)."""
    lifted = _lifted(k, n, cn)
    rng = np.random.default_rng(k)
    llr = torch.as_tensor(rng.normal(2.0, 3.0, (3, lifted._num_vns)),
                          dtype=torch.float32)
    layout = layered_bp_layout(lifted, storage)
    for it in (0, 1, 2):
        got = _emulate_k3(lifted, layout, llr, it, storage)
        want = lifted.decode_layered(llr, it, storage)
        assert torch.equal(got, want), (it, float((got - want).abs().max()))
