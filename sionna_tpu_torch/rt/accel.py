"""Ray-tracing acceleration: dense cluster culling.

PyTorch counterpart of ``sionna_tpu/rt/accel.py``, the same two-level
scheme:

1.  A native C++ builder (``csrc/bvh_cluster.cpp``, median-split BVH
    order, built with g++ at first use) groups triangles into spatially
    coherent clusters of fixed size ``C`` (padding only the single
    global tail cluster). A NumPy version of the same algorithm serves
    hosts without g++.
2.  On the device, a query slab-tests every ray against every cluster
    AABB (one dense ``[R, n_clusters]`` computation), takes each ray's
    ``k_max`` nearest-entry clusters (a stable sort: ties in JAX's
    ``lax.top_k`` order, lower index first), and Moller-Trumbore-tests
    them ``group`` gathered clusters per step. A ray is proven resolved
    when its best hit is no farther than its ``k_max``-th entry time (a
    hit inside a box is never closer than the box's entry) or it entered
    at most ``k_max`` clusters; the rare rest are re-solved by a dense
    all-cluster sweep. Results match the dense sweep exactly.

Each ray chunk of a query makes two host syncs: one that skips chunks
whose rays enter no cluster (sky rays) and one that decides whether the
dense repair sweep runs. ``STATS`` counts chunks, skips, repairs and
builds.
"""

import ctypes
import hashlib
import shutil
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .._build import HostLibrary

__all__ = ["TriangleAccel", "build_accel", "nearest_hit_accel",
           "any_blocking_hit_accel", "transmission_product_accel",
           "transmission_jones_product_accel", "cluster_permutation",
           "STATS"]

_EPS = 1e-5


def edge_tol(dtype):
    """Barycentric tolerance of the Moller-Trumbore tests: a ray through
    an edge hits the triangles on both sides of it. 1e-9 in float64 (the
    JAX package's); 1e-6 in float32, above its rounding of u and v
    (about 1e-7), where 1e-9 lets a ray through a shared edge miss both
    triangles (a blocker lost on the card)."""
    return 1e-9 if dtype == torch.float64 else 1e-6

BVH_BUILDER = HostLibrary(
    "bvh_cluster", "bvh_cluster.cpp",
    {"sionna_bvh_cluster": ([ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int64, ctypes.c_int32,
                             ctypes.POINTER(ctypes.c_int32)], None)})


class AccelStats:
    """Counts of the acceleration structure's work since ``reset``:
    permutations built natively and in NumPy (``native_builds``,
    ``numpy_builds``, ``build_s`` seconds on the host, compile
    excluded), query ray chunks (``chunks``), chunks skipped because no
    ray entered a cluster (``skipped``) and chunks that ran the dense
    repair sweep (``repairs``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.native_builds = 0
        self.numpy_builds = 0
        self.build_s = 0.0
        self.chunks = 0
        self.skipped = 0
        self.repairs = 0


STATS = AccelStats()


# ----------------------------------------------------------------------
# Host-side builder (native C++; NumPy for hosts without g++)
# ----------------------------------------------------------------------
def _native_lib():
    """The C++ cluster builder, or None on a host without g++ (a failed
    compile raises)."""
    if shutil.which("g++") is None:
        return None
    return BVH_BUILDER.library()


def _cluster_permutation_numpy(tris, cluster_size):
    """NumPy median-split builder: the same algorithm as bvh_cluster.cpp."""
    cent = tris.mean(axis=1)                            # [T, 3]
    out = np.empty(tris.shape[0], np.int32)
    cursor = [0]

    def split(ids):
        n = ids.shape[0]
        if n <= cluster_size:
            out[cursor[0]:cursor[0] + n] = ids
            cursor[0] += n
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        left_n = (n // 2 // cluster_size) * cluster_size
        left_n = min(max(left_n, cluster_size), n - 1)
        part = np.argpartition(c[:, axis], left_n)
        split(ids[part[:left_n]])
        split(ids[part[left_n:]])

    limit = sys.getrecursionlimit()
    depth_bound = 2 * int(np.ceil(np.log2(
        max(tris.shape[0] / max(cluster_size, 1), 2)))) + 64
    sys.setrecursionlimit(max(limit, depth_bound + limit))
    try:
        split(np.arange(tris.shape[0], dtype=np.int32))
    finally:
        sys.setrecursionlimit(limit)
    return out


def cluster_permutation(tris, cluster_size=64):
    """[T] int32 permutation grouping ``tris`` [T, 3, 3] into spatially
    coherent runs of ``cluster_size`` (the native C++ builder, NumPy on a
    host without g++)."""
    num_tri = tris.shape[0]
    if num_tri == 0:
        return np.zeros((0,), np.int32)
    lib = _native_lib()
    t0 = time.perf_counter()
    if lib is None:
        perm = _cluster_permutation_numpy(
            np.asarray(tris, np.float32), cluster_size)
        STATS.numpy_builds += 1
    else:
        flat = np.ascontiguousarray(tris, np.float32).reshape(-1)
        perm = np.empty(num_tri, np.int32)
        lib.sionna_bvh_cluster(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            num_tri, cluster_size,
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        STATS.native_builds += 1
    STATS.build_s += time.perf_counter() - t0
    return perm


# ----------------------------------------------------------------------
# Device-side structure
# ----------------------------------------------------------------------
class TriangleAccel(NamedTuple):
    """Clustered geometry (tensors on one device).

    tri_c  : [n_c, C, 3, 3] clustered triangles (tail padded with
             degenerate zero-triangles that can never be hit)
    old_id : [n_c, C] int64 original triangle index (-1 on padding)
    lo, hi : [n_c, 3] cluster AABBs
    """
    tri_c: torch.Tensor
    old_id: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def num_clusters(self):
        return self.tri_c.shape[0]

    @property
    def cluster_size(self):
        return self.tri_c.shape[1]


_ACCEL_CACHE = {}
_ACCEL_CACHE_MAX = 8


def build_accel(tris, device, cluster_size=64):
    """Builds (and caches, keyed by the geometry's bytes and the device)
    a TriangleAccel on ``device`` from host triangles [T, 3, 3]; the
    arrays keep the dtype of ``tris``."""
    tris = np.asarray(tris)
    device = torch.device(device)
    key = (hashlib.blake2b(
        np.ascontiguousarray(tris, np.float32).tobytes(),
        digest_size=16).hexdigest(), cluster_size, tris.dtype.str,
        str(device))
    hitv = _ACCEL_CACHE.get(key)
    if hitv is not None:
        return hitv
    num_tri = tris.shape[0]
    perm = cluster_permutation(tris, cluster_size)
    n_c = -(-num_tri // cluster_size)
    pad = n_c * cluster_size - num_tri
    tri_sorted = tris[perm]
    tri_p = np.concatenate(
        [tri_sorted, np.zeros((pad, 3, 3), tris.dtype)], axis=0)
    old_id = np.concatenate([perm, np.full((pad,), -1, np.int32)])
    tri_c = tri_p.reshape(n_c, cluster_size, 3, 3)
    # AABB over real triangles only (padding is all-zeros; excluding
    # it keeps boxes tight). A small margin guards watertightness.
    verts = tri_c.reshape(n_c, -1, 3)
    counts = np.minimum(
        np.maximum(num_tri - np.arange(n_c) * cluster_size, 1),
        cluster_size)
    lo = np.empty((n_c, 3), tris.dtype)
    hi = np.empty((n_c, 3), tris.dtype)
    for i in range(n_c):
        v = verts[i, :counts[i] * 3]
        lo[i] = v.min(axis=0)
        hi[i] = v.max(axis=0)
    margin = 1e-4 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-6
    accel = TriangleAccel(
        tri_c=torch.as_tensor(tri_c, device=device),
        old_id=torch.as_tensor(old_id.reshape(n_c, cluster_size)
                               .astype(np.int64), device=device),
        lo=torch.as_tensor((lo - margin).astype(tris.dtype),
                           device=device),
        hi=torch.as_tensor((hi + margin).astype(tris.dtype),
                           device=device))
    if len(_ACCEL_CACHE) >= _ACCEL_CACHE_MAX:
        _ACCEL_CACHE.pop(next(iter(_ACCEL_CACHE)))
    _ACCEL_CACHE[key] = accel
    return accel


# ----------------------------------------------------------------------
# Queries
# ----------------------------------------------------------------------
def _slab_entry(orig, dirs, lo, hi, t_hi):
    """Ray/AABB slab test. orig, dirs: [R, 3]; lo, hi: [n_c, 3].

    Returns t_entry [R, n_c]: the entry parameter (clamped to 0) for
    rays that intersect the box within (0, t_hi), +inf otherwise.
    Computed axis by axis, so no [R, n_c, 3] intermediate exists."""
    inv = 1. / torch.where(torch.abs(dirs) < 1e-30, 1e-30, dirs)
    tmin = None
    tmax = None
    for a in range(3):
        t0 = (lo[None, :, a] - orig[:, None, a]) * inv[:, None, a]
        t1 = (hi[None, :, a] - orig[:, None, a]) * inv[:, None, a]
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    t_entry = torch.clamp(tmin, min=0.)
    ok = (tmax >= t_entry) & (t_entry < t_hi)
    return torch.where(ok, t_entry, torch.inf)


def _mt_per_ray(orig, dirs, tri):
    """Moller-Trumbore where each ray has its own triangle set.

    orig/dirs: [R, 3]; tri: [R, C, 3, 3] (or [1, C, 3, 3], shared by
    every ray). Returns (t, hit) [R, C]. Same tolerances as
    geometry.moller_trumbore; component arithmetic, so the largest
    intermediates are [R, C]."""
    dx, dy, dz = (dirs[:, i:i + 1] for i in range(3))
    ox, oy, oz = (orig[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z = (tri[:, :, 0, i] for i in range(3))
    e1x, e1y, e1z = (tri[:, :, 1, i] - tri[:, :, 0, i] for i in range(3))
    e2x, e2y, e2z = (tri[:, :, 2, i] - tri[:, :, 0, i] for i in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z                 # [R, C]
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1. / torch.where(ok, det, 1.), 0.)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    tol = edge_tol(t.dtype)
    hit = (ok & (u >= -tol) & (v >= -tol) & (u + v <= 1. + tol)
           & (t > _EPS))
    return t, hit


def smallest_k(x, k):
    """(values, indices) of the ``k`` smallest entries of each row of
    ``x``, ascending, ties lower index first (the order of JAX's
    ``lax.top_k`` on ``-x``)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _top_clusters(t_entry, k_max, group):
    """The ``kk`` nearest-entry cluster ids per ray (ascending entry
    time), padded to a multiple of ``group``. Padding repeats cluster
    id 0 with +inf entry: re-testing a real cluster is correct for the
    nearest hit and for occlusion; the slot collectors mask it by its
    entry time. Returns (ids [R, kk'], t_sort [R, kk'], n_steps,
    v_last [R] the kk-th entry time, cnt [R] entered-cluster counts)."""
    n_c = t_entry.shape[1]
    kk = min(k_max, n_c)
    cnt = torch.sum(torch.isfinite(t_entry), dim=1)
    t_sort, ids = smallest_k(t_entry, kk)
    v_last = t_sort[:, -1]
    pad = (-kk) % group
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad))
        t_sort = torch.nn.functional.pad(t_sort, (0, pad),
                                         value=torch.inf)
    return ids, t_sort, (kk + pad) // group, v_last, cnt


def _gather_clusters(accel, cid):
    """Triangles [R, G*C, 3, 3] and original ids [R, G*C] of the
    clusters ``cid`` [R, G]."""
    r = cid.shape[0]
    csz = accel.cluster_size
    tri = accel.tri_c[cid].reshape(r, -1, 3, 3)
    eid = accel.old_id[cid].reshape(r, cid.shape[1] * csz)
    return tri, eid


def _dense_groups(accel, tri_chunk_clusters=128):
    """Cluster-id groups of the dense sweep: [(cid [g], wrap [g])], the
    last group wrapping around to cluster 0 with ``wrap`` marking the
    re-visits (as JAX's fixed-size scan does)."""
    n_c = accel.num_clusters
    g = min(tri_chunk_clusters, n_c)
    n_steps = -(-n_c // g)
    dev = accel.tri_c.device
    cids = torch.arange(n_steps * g, device=dev)
    wrap = cids >= n_c
    cids = (cids % n_c).reshape(n_steps, g)
    wrap = wrap.reshape(n_steps, g)
    return list(zip(cids, wrap))


def _dense_sweep(o, d, accel, mode, excl=None, tri_chunk_clusters=128):
    """Exact sweep over ALL clusters in fixed-size groups. mode
    "nearest" -> (t_min, idx); mode "occl" -> blocked."""
    r = o.shape[0]
    csz = accel.cluster_size
    if mode == "nearest":
        best_t = torch.full((r,), torch.inf, dtype=o.dtype,
                            device=o.device)
        best_id = torch.zeros((r,), dtype=torch.int64, device=o.device)
    else:
        blocked = torch.zeros((r,), dtype=torch.bool, device=o.device)
    for cid, _ in _dense_groups(accel, tri_chunk_clusters):
        tri = accel.tri_c[cid].reshape(1, -1, 3, 3)
        ids = accel.old_id[cid].reshape(1, cid.shape[0] * csz)
        t, hit = _mt_per_ray(o, d, tri)
        if mode == "nearest":
            t = torch.where(hit & (ids >= 0), t, torch.inf)
            t_loc, i_loc = torch.min(t, dim=-1)
            id_loc = ids[0, i_loc]
            better = t_loc < best_t
            best_t = torch.where(better, t_loc, best_t)
            best_id = torch.where(better, id_loc, best_id)
        else:
            b = hit & (ids >= 0) & (t > 1e-4) & (t < 1. - 1e-4)
            if excl is not None:
                b = b & ~torch.any(
                    ids[:, :, None] == excl[:, None, :], dim=-1)
            blocked = blocked | torch.any(b, dim=-1)
    if mode == "nearest":
        return best_t, best_id
    return blocked


def _ray_chunks(num_rays, ray_chunk):
    return [slice(b, min(b + ray_chunk, num_rays))
            for b in range(0, max(num_rays, 1), ray_chunk)]


def nearest_hit_accel(orig, dirs, accel, ray_chunk=8192, group=16,
                      k_max=32):
    """Nearest intersection per ray through the cluster structure.

    Each ray's ``k_max`` nearest-entry clusters are tested, ``group``
    clusters per step; a ray is proven resolved when its best hit is no
    farther than the k_max-th entry time or it entered <= k_max
    clusters, and the rest of its chunk's unproven rays are re-solved
    by the dense all-cluster sweep.
    Returns (t_min [R], tri_idx (original ids) [R], has_hit [R])."""
    t_out, i_out = [], []
    for sl in _ray_chunks(orig.shape[0], ray_chunk):
        o, d = orig[sl], dirs[sl]
        r = o.shape[0]
        STATS.chunks += 1
        t_entry = _slab_entry(o, d, accel.lo, accel.hi, torch.inf)
        ids, _, n_steps, v_last, cnt = _top_clusters(
            t_entry, k_max, group)
        del t_entry
        best_t = torch.full((r,), torch.inf, dtype=o.dtype,
                            device=o.device)
        best_id = torch.zeros((r,), dtype=torch.int64, device=o.device)
        # skip chunks whose rays enter no cluster (sky rays)
        if bool(torch.any(cnt > 0)):
            for k in range(n_steps):
                tri, eid = _gather_clusters(
                    accel, ids[:, k * group:(k + 1) * group])
                t, hit = _mt_per_ray(o, d, tri)
                del tri
                t = torch.where(hit & (eid >= 0), t, torch.inf)
                t_loc, i_loc = torch.min(t, dim=-1)
                id_loc = torch.gather(eid, 1, i_loc[:, None])[:, 0]
                better = t_loc < best_t
                best_t = torch.where(better, t_loc, best_t)
                best_id = torch.where(better, id_loc, best_id)
        else:
            STATS.skipped += 1
        exact = (cnt <= k_max) | (best_t <= v_last)
        if not bool(torch.all(exact)):
            STATS.repairs += 1
            d_t, d_id = _dense_sweep(o, d, accel, "nearest")
            best_t = torch.where(exact, best_t, d_t)
            best_id = torch.where(exact, best_id, d_id)
        t_out.append(best_t)
        i_out.append(best_id)
    t_min = torch.cat(t_out)
    return t_min, torch.cat(i_out), torch.isfinite(t_min)


def any_blocking_hit_accel(orig, dirs, accel, excl_ids=None,
                           ray_chunk=8192, group=16, k_max=32):
    """Segment occlusion through the cluster structure.

    Same semantics as geometry.any_blocking_hit: whether the segment
    [orig, orig + dirs] hits any triangle with parameter in
    (1e-4, 1 - 1e-4), ignoring original triangle ids in ``excl_ids``
    [R, K]. Exact: rays that entered more than ``k_max`` clusters
    without a blocker are re-solved by the dense sweep."""
    out = []
    for sl in _ray_chunks(orig.shape[0], ray_chunk):
        o, d = orig[sl], dirs[sl]
        excl = None if excl_ids is None else excl_ids[sl]
        r = o.shape[0]
        STATS.chunks += 1
        t_entry = _slab_entry(o, d, accel.lo, accel.hi, 1.)
        ids, _, n_steps, _, cnt = _top_clusters(t_entry, k_max, group)
        del t_entry
        blocked = torch.zeros((r,), dtype=torch.bool, device=o.device)
        if bool(torch.any(cnt > 0)):
            for k in range(n_steps):
                tri, eid = _gather_clusters(
                    accel, ids[:, k * group:(k + 1) * group])
                t, hit = _mt_per_ray(o, d, tri)
                del tri
                b = hit & (eid >= 0) & (t > 1e-4) & (t < 1. - 1e-4)
                if excl is not None:
                    b = b & ~torch.any(
                        eid[:, :, None] == excl[:, None, :], dim=-1)
                blocked = blocked | torch.any(b, dim=-1)
        else:
            STATS.skipped += 1
        exact = blocked | (cnt <= k_max)
        if not bool(torch.all(exact)):
            STATS.repairs += 1
            d_b = _dense_sweep(o, d, accel, "occl", excl=excl)
            blocked = blocked | (~exact & d_b)
        out.append(blocked)
    return torch.cat(out)


def _collect_slots(orig, dirs, accel, th_tri, e_a, e_b, excl_ids,
                   ray_chunk, group, k_max, init, fold):
    """Shared loop of the blocker queries: for each ray chunk, folds
    ``fold(carry, cand)`` over the blocker candidates of the ray's
    ``k_max`` nearest-entry clusters (``group`` per step), starting from
    ``init(r)``; a chunk with a ray that entered more than ``k_max``
    clusters folds that ray again over every cluster (the dense sweep).
    Returns the per-chunk carries, concatenated by ``torch.cat`` on each
    field."""
    from .em import blocker_candidates

    csz = accel.cluster_size
    th_f = th_tri.to(torch.float32)
    d_hat_all = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-30)
    outs = []
    for sl in _ray_chunks(orig.shape[0], ray_chunk):
        o, d, dh = orig[sl], dirs[sl], d_hat_all[sl]
        ea = None if e_a is None else e_a[sl]
        eb = None if e_b is None else e_b[sl]
        excl = None if excl_ids is None else excl_ids[sl]
        r = o.shape[0]
        STATS.chunks += 1
        t_entry = _slab_entry(o, d, accel.lo, accel.hi, 1.)
        ids, t_sort, n_steps, _, cnt = _top_clusters(
            t_entry, k_max, group)
        del t_entry
        carry = init(r)
        if bool(torch.any(cnt > 0)):
            for k in range(n_steps):
                cols = slice(k * group, (k + 1) * group)
                tri, eid = _gather_clusters(accel, ids[:, cols])
                # padded top-k slots (inf entry) must not contribute
                eid = torch.where(torch.repeat_interleave(
                    torch.isfinite(t_sort[:, cols]), csz, dim=1), eid, -1)
                cand = blocker_candidates(o, d, dh, tri, None, eid, th_f,
                                          ea, eb, excl)
                del tri
                carry = fold(carry, cand)
        else:
            STATS.skipped += 1
        exact = cnt <= k_max
        if not bool(torch.all(exact)):
            STATS.repairs += 1
            dense = init(r)
            for cid, wrap in _dense_groups(accel):
                tri = accel.tri_c[cid].reshape(-1, 3, 3)
                eid = torch.where(wrap[:, None], -1,
                                  accel.old_id[cid]).reshape(-1)
                cand = blocker_candidates(o, d, dh, tri, None, eid, th_f,
                                          ea, eb, excl)
                dense = fold(dense, cand)
            carry = _select(exact, carry, dense)
        outs.append(carry)
    if isinstance(outs[0], dict):
        return {key: torch.cat([o[key] for o in outs])
                for key in outs[0]}
    return torch.cat(outs)


def _select(exact, kept, dense):
    if isinstance(kept, dict):
        return {key: torch.where(exact[:, None], kept[key], dense[key])
                for key in kept}
    return torch.where(exact, kept, dense)


def _collect_blockers_accel(orig, dirs, accel, th_tri, e_a=None,
                            e_b=None, excl_ids=None, ray_chunk=8192,
                            group=16, k_max=32):
    """Blocker-slot collection through the cluster structure: the K
    nearest-t blocking triangles of each segment [orig, orig+dirs]
    (see em.py's blocker-slot note). Only cheap geometry runs in the
    per-cluster loop; the caller evaluates slab/Jones factors on the K
    slots once. A ray is exact when it entered at most ``k_max``
    clusters; the rest are re-collected by the dense sweep."""
    from .em import empty_blocker_slots, merge_blocker_slots

    return _collect_slots(
        orig, dirs, accel, th_tri, e_a, e_b, excl_ids, ray_chunk, group,
        k_max, lambda r: empty_blocker_slots(r, device=orig.device),
        merge_blocker_slots)


def transmission_product_accel(orig, dirs, accel, eta_tri, th_tri,
                               lam, excl_ids=None, ray_chunk=8192,
                               group=16, k_max=32):
    """Complex polarization-averaged slab-transmission product of each
    segment through EVERY blocking triangle, via the cluster structure
    (the ``refraction`` analog of :func:`any_blocking_hit_accel`). The
    scalar product is commutative, so every blocker's factor is
    accumulated per visited cluster group: exact (matches the dense
    :func:`em.transmission_product`)."""
    from .em import scalar_from_slots

    def fold(prod, cand):
        return prod * scalar_from_slots(cand, eta_tri, th_tri, lam)

    return _collect_slots(
        orig, dirs, accel, th_tri, None, None, excl_ids, ray_chunk,
        group, k_max,
        lambda r: torch.ones((r,), dtype=torch.complex64,
                             device=orig.device), fold)


def transmission_jones_product_accel(orig, dirs, accel, eta_tri,
                                     th_tri, lam, e_a, e_b,
                                     excl_ids=None, ray_chunk=8192,
                                     group=16, k_max=32):
    """Polarimetric analog of :func:`transmission_product_accel`: the
    ordered 2x2 Jones cascade of per-blocker TE/TM slab coefficients
    (see :func:`em.transmission_jones_product`) through the cluster
    structure. e_a/e_b: [R, 3] transverse basis of each segment.
    Returns [R, 2, 2] complex64.

    Slots are merged in ascending-t order, so the cascade applies
    factors in along-ray crossing order. Only the K = 16 nearest
    blockers contribute: each dropped factor has |t| < 1, so truncation
    can only overestimate a path that 16+ walls have already pushed
    below -100 dB."""
    from .em import jones_from_slots
    slots = _collect_blockers_accel(
        orig, dirs, accel, th_tri, e_a=e_a, e_b=e_b,
        excl_ids=excl_ids, ray_chunk=ray_chunk, group=group,
        k_max=k_max)
    return jones_from_slots(slots, eta_tri, th_tri, lam)
