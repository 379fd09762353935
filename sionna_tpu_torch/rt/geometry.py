"""Geometry primitives for the RT solver: ray-triangle intersection,
bounce tracing, on-device sequence dedupe and spherical bases.

PyTorch counterpart of ``sionna_tpu/rt/geometry.py``. Dense batched
Moller-Trumbore over [num_rays, num_triangles] for small scenes; large
scenes route through the clustered acceleration structure in accel.py.
Geometry is float64 on the CPU and float32 on the card
(:func:`real_dtype`); field values are complex64 on both, and
:func:`phase_exp` reduces phases mod 2 pi in the geometry dtype so
km-long paths keep their phase in float32.
"""

import numpy as np
import torch

from ..phy.config import config
from ..phy.constants import PI
from .accel import any_blocking_hit_accel, edge_tol, nearest_hit_accel

EPS = 1e-5


def resolve_device(device=None):
    """``device`` as a torch.device (default ``config.device``), with the
    current card's index when it names the card without one."""
    device = torch.device(config.device if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def real_dtype(device):
    """Geometry dtype on ``device``: float64 on the CPU (tight test
    tolerances), float32 on the card. Index tensors are int64 on both
    (``torch.gather`` takes no other)."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def normalize(v, dim=-1):
    n = torch.linalg.norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=1e-30)


def phase_exp(length, lam, sign=-1.):
    """exp(sign * 2j pi length / lam) as complex64.

    The angle is reduced mod 2 pi in the input precision before the
    complex exponential, so long paths keep accurate phases."""
    ang = torch.remainder(length / lam, 1.) * (2. * PI)
    return torch.exp(1j * (sign * ang).to(torch.float32))


def moller_trumbore(orig, dirs, tri):
    """Batched ray-triangle intersection.

    orig/dirs: [R, 3]; tri: [T, 3, 3].
    Returns (t [R, T], hit [R, T] bool) with t the ray parameter.
    Every large intermediate is [R, T] (component arithmetic)."""
    dx, dy, dz = (dirs[:, i:i + 1] for i in range(3))
    ox, oy, oz = (orig[:, i:i + 1] for i in range(3))
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    # p = dirs x e2                                     [R, T]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1. / torch.where(ok, det, 1.), 0.)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    # q = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    tol = edge_tol(t.dtype)
    hit = (ok & (u >= -tol) & (v >= -tol) & (u + v <= 1. + tol)
           & (t > EPS))
    return t, hit


def _tri_chunks(num_rays, tri, max_elems):
    """Triangle chunks (views) of at most ``max_elems // num_rays``
    triangles (at least 64), with their first global index."""
    num_tri = tri.shape[0]
    chunk = num_tri if num_rays * num_tri <= max_elems \
        else max(64, max_elems // max(num_rays, 1))
    return [(tri[b:b + chunk], b) for b in range(0, num_tri, chunk)]


def nearest_hit(orig, dirs, tri, max_elems=16_000_000, accel=None):
    """Nearest intersection per ray, chunking over triangles so the
    [rays, triangles] workspace stays bounded for large scenes. With
    ``accel`` (a TriangleAccel over the same ``tri``), the query runs
    through the clustered culling structure instead.

    Returns (t_min [R], tri_idx [R] int64, has_hit [R])."""
    if accel is not None:
        return nearest_hit_accel(orig, dirs, accel)
    num_rays = orig.shape[0]
    t_min = torch.full((num_rays,), torch.inf, dtype=tri.dtype,
                       device=tri.device)
    idx = torch.zeros((num_rays,), dtype=torch.int64, device=tri.device)
    for tri_chunk, base in _tri_chunks(num_rays, tri, max_elems):
        t, hit = moller_trumbore(orig, dirs, tri_chunk)
        t = torch.where(hit, t, torch.inf)
        t_loc, i_loc = torch.min(t, dim=-1)
        better = t_loc < t_min
        t_min = torch.where(better, t_loc, t_min)
        idx = torch.where(better, base + i_loc, idx)
    return t_min, idx, torch.isfinite(t_min)


def any_blocking_hit(orig, dirs, tri, excl_ids=None,
                     max_elems=16_000_000, accel=None):
    """Whether each segment [orig, orig+dirs] intersects any triangle
    with ray parameter in (1e-4, 1-1e-4), ignoring triangles listed in
    ``excl_ids`` [R, K]; chunked over triangles. With ``accel``, the
    query runs through the clustered culling structure instead."""
    if accel is not None:
        return any_blocking_hit_accel(orig, dirs, accel,
                                      excl_ids=excl_ids)
    num_rays = orig.shape[0]
    blocked = torch.zeros((num_rays,), dtype=torch.bool,
                          device=orig.device)
    for tri_chunk, base in _tri_chunks(num_rays, tri, max_elems):
        t, hit = moller_trumbore(orig, dirs, tri_chunk)
        b = hit & (t > 1e-4) & (t < 1. - 1e-4)
        if excl_ids is not None:
            gid = base + torch.arange(tri_chunk.shape[0],
                                      device=orig.device)
            excl = torch.any(
                gid[None, None, :] == excl_ids[:, :, None], dim=1)
            b = b & ~excl
        blocked = blocked | torch.any(b, dim=-1)
    return blocked


def tri_normals(tri):
    """[T, 3] unit normals"""
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return normalize(n)


def trace(tri, normals, orig, dirs, depth, accel=None):
    """Traces rays through ``depth`` specular bounces.

    Returns hit-triangle ids [R, depth] int64 (-1 once escaped)."""
    num_rays = orig.shape[0]
    o, d = orig, dirs
    active = torch.ones((num_rays,), dtype=torch.bool, device=orig.device)
    ids = []
    for _ in range(depth):
        t_min, idx, found = nearest_hit(o, d, tri, accel=accel)
        has_hit = found & active
        n = normals[idx]                               # [R, 3]
        # flip normal to face the incoming ray
        n = torch.where(torch.sum(n * d, dim=-1, keepdim=True) > 0, -n, n)
        p_hit = o + t_min[:, None] * d
        d_ref = d - 2. * torch.sum(d * n, dim=-1, keepdim=True) * n
        o = torch.where(has_hit[:, None], p_hit + EPS * d_ref, o)
        d = torch.where(has_hit[:, None], d_ref, d)
        ids.append(torch.where(has_hit, idx, -1))
        active = has_hit
    if not ids:
        return torch.zeros((num_rays, 0), dtype=torch.int64,
                           device=orig.device)
    return torch.stack(ids, dim=1)                     # [R, depth]


def lexsort_rows(rows):
    """Permutation that sorts the rows of ``rows`` [R, d]
    lexicographically ascending (column 0 first): a chain of stable
    sorts from the last column to the first (torch has no lexsort)."""
    perm = torch.arange(rows.shape[0], device=rows.device)
    for c in range(rows.shape[1] - 1, -1, -1):
        order = torch.sort(rows[perm, c], stable=True).indices
        perm = perm[order]
    return perm


def trace_unique(tri, normals, orig, dirs, depth, cap, accel=None):
    """Traces rays and deduplicates hit-sequence prefixes on the device.

    For each prefix length d in 1..depth, returns the unique all-hit
    prefixes, sorted ascending (as np.unique sorts them), left-compacted
    into a [cap, d] buffer padded with -1, and the unique count (clipped
    to cap).

    Returns (uniq: tuple of [cap, d] int64, counts: [depth] int64)."""
    ids = trace(tri, normals, orig, dirs, depth, accel)  # [R, depth]
    num_tri = tri.shape[0]
    uniq_all, counts = [], []
    for d in range(1, depth + 1):
        pref = ids[:, :d]                              # [R, d]
        valid = torch.all(pref >= 0, dim=1)            # [R]
        # invalid rows -> sentinel num_tri in every column: they sort
        # last and can never collide with a valid prefix
        key_rows = torch.where(valid[:, None], pref, num_tri)
        perm = lexsort_rows(key_rows)
        rows = key_rows[perm]                          # [R, d] sorted
        valid_s = valid[perm]
        first = torch.cat(
            [torch.ones((1,), dtype=torch.bool, device=ids.device),
             torch.any(rows[1:] != rows[:-1], dim=1)])
        new = first & valid_s
        dest = torch.cumsum(new.to(torch.int64), 0) - 1   # [R]
        n_uniq = torch.clamp(dest[-1] + 1, max=cap)
        # one spare row takes the dropped writes (non-first rows and
        # prefixes past the cap)
        dest = torch.where(new & (dest < cap), dest, cap)
        out = torch.full((cap + 1, d), -1, dtype=torch.int64,
                         device=ids.device)
        out.index_put_((dest,), rows)
        uniq_all.append(out[:cap])
        counts.append(n_uniq)
    return tuple(uniq_all), torch.stack(counts)


def fibonacci_sphere(n):
    """[n, 3] quasi-uniform directions on the unit sphere (NumPy)"""
    i = np.arange(n) + 0.5
    phi = np.pi * (1. + np.sqrt(5.)) * i
    z = 1. - 2. * i / n
    r = np.sqrt(np.maximum(1. - z ** 2, 0.))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def rot_matrix(orientation):
    """ZYX rotation matrices [..., 3, 3] from [..., 3] orientations
    [yaw, pitch, roll] (TR 38.901 7.1-4), NumPy."""
    a, b, c = np.moveaxis(np.asarray(orientation, np.float64), -1, 0)
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    return np.stack([
        np.stack([ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc],
                 -1),
        np.stack([sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc],
                 -1),
        np.stack([-sb, cb * sc, cb * cc], -1)], -2)


def unit_to_angles(v):
    """Unit vectors [..., 3] -> (theta, phi)"""
    theta = torch.arccos(torch.clamp(v[..., 2], -1., 1.))
    phi = torch.arctan2(v[..., 1], v[..., 0])
    return theta, phi


def sph_basis(v):
    """Spherical unit vectors (e_theta, e_phi) transverse to
    direction v [..., 3]."""
    theta, phi = unit_to_angles(v)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    e_theta = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    e_phi = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    return e_theta, e_phi


def in_triangle(p, a, b, c):
    """Barycentric inside-test for points p against triangles
    (a, b, c), broadcasting over leading dims."""
    v0 = c - a
    v1 = b - a
    v2 = p - a
    d00 = torch.sum(v0 * v0, -1)
    d01 = torch.sum(v0 * v1, -1)
    d11 = torch.sum(v1 * v1, -1)
    d20 = torch.sum(v2 * v0, -1)
    d21 = torch.sum(v2 * v1, -1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) > 1e-18, denom, 1e-18)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1. + 1e-6)
