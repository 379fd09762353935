"""Electromagnetic (Jones/Fresnel) algebra for the RT solver:
single-interface Fresnel coefficients, ITU-R P.2040 slab transmission,
and the per-segment through-blocker transmission product.

PyTorch counterpart of ``sionna_tpu/rt/em.py``; every interaction
evaluator (specular, diffraction, scattering, transmission) shares it.
"""

import torch

from ..phy.constants import PI
from .accel import edge_tol
from .geometry import tri_normals


def fresnel_coefficients(cos_i, eta):
    """Single-interface Fresnel reflection coefficients for incidence
    from vacuum onto a medium of complex relative permittivity ``eta``.

    cos_i: |cos| of the incidence angle (real, broadcastable to eta).
    Returns (r_te, r_tm) complex:

        r_te = (cos t - sqrt(eta - sin^2 t)) / (cos t + sqrt(...))
        r_tm = (eta cos t - sqrt(...)) / (eta cos t + sqrt(...))
    """
    sin2 = 1. - cos_i ** 2
    root = torch.sqrt(eta - sin2)
    r_te = (cos_i - root) / (cos_i + root)
    r_tm = (eta * cos_i - root) / (eta * cos_i + root)
    return r_te, r_tm


def slab_transmission(cos_i, eta, d_th, lam):
    """ITU-R P.2040 single-layer slab transmission coefficients.

    cos_i: |cos| of the incidence angle (broadcastable), eta: complex
    relative permittivity, d_th: slab thickness [m], lam: wavelength
    [m]. Returns (t_te, t_tm) complex field transmission through the
    slab including internal multiple reflections:

        T = (1 - r^2) e^{-jq} / (1 - r^2 e^{-2jq}),
        q = 2 pi d/lam * sqrt(eta - sin^2 theta_1)

    with r the TE/TM single-interface Fresnel coefficient, times the
    insertion correction e^{+j 2 pi d cos(theta_1) / lam}: the
    geometric path already counts the slab crossing as free space, so
    the returned factor is the slab's INSERTION transfer function
    (vacuum -> exactly 1)."""
    cos_i = torch.clamp(cos_i, 0., 1.)
    sin2 = 1. - cos_i ** 2
    root = torch.sqrt(eta - sin2)
    r_te = (cos_i - root) / (cos_i + root)
    r_tm = (eta * cos_i - root) / (eta * cos_i + root)
    q = (2. * PI * d_th / lam) * root
    corr = torch.exp(1j * (2. * PI * d_th / lam)
                     * cos_i.to(torch.complex64))
    e1 = torch.exp(-1j * q.to(torch.complex64))

    def slab(r):
        return ((1. - r ** 2) * e1
                / (1. - (r ** 2) * e1 * e1 + 1e-30)) * corr

    return (slab(r_te.to(torch.complex64)),
            slab(r_tm.to(torch.complex64)))


# ----------------------------------------------------------------------
# Blocker-candidate machinery. `blocker_candidates` computes the
# per-(ray, triangle) geometry fields of a blocking crossing (hit
# parameter t, incidence cosine, TE-axis rotation (c, s), and original
# triangle id; non-blocking entries carry t = +inf / eid = -1). Two
# consumers:
#
# * The DENSE sweep sorts each chunk's candidates by t and evaluates
#   slab/Jones factors on them directly.
#
# * The CLUSTERED path (accel.py) merges candidates into each segment's
#   K nearest-t blocker SLOTS inside the cluster loop, then runs the
#   complex slab transcendentals and the ordered 2x2 Jones cascade on
#   just those K slots, in along-ray crossing order.
#
# A segment crossing more than K blockers keeps the K nearest; each
# dropped slab factor has |t| < 1, so the kept product only
# *overestimates* the magnitude of a path that K building walls have
# already attenuated to irrelevance (16 concrete walls ~ -100 dB).
# ----------------------------------------------------------------------

DEFAULT_K_BLOCKERS = 16

_SLOT_KEYS = ("t", "cos_i", "c", "s", "eid")


def empty_blocker_slots(num_rays, k_blockers=DEFAULT_K_BLOCKERS,
                        device=None):
    """Initial slot carry: no blockers."""
    shape = (num_rays, k_blockers)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "t": torch.full(shape, torch.inf, **f32),
        "cos_i": torch.zeros(shape, **f32),
        "c": torch.ones(shape, **f32),
        "s": torch.zeros(shape, **f32),
        "eid": torch.full(shape, -1, dtype=torch.int64, device=device),
    }


def blocker_candidates(orig, dirs, d_hat, tri, n_tri, eid, th_tri,
                       e_a=None, e_b=None, excl_ids=None):
    """Per-(ray, triangle) blocker candidate fields for one triangle
    group.

    orig/dirs/d_hat: [R, 3]; tri: [R, C, 3, 3] or [C, 3, 3];
    n_tri: matching unit normals [..., C, 3], or None to compute them
    here (from the MT edge vectors); eid: [R, C] or [C] original
    triangle ids (-1 = padding); th_tri: [num_tri] thickness;
    e_a/e_b: [R, 3] transverse basis (optional, only needed for the
    polarimetric cascade). Returns a slot-field dict of [R, C] tensors
    where non-blocking entries carry t = +inf / eid = -1.

    Component arithmetic: the largest intermediates are [R, C]."""
    if tri.ndim == 3:
        tri = tri[None]
        if n_tri is not None:
            n_tri = n_tri[None]
    if eid.ndim == 1:
        eid = eid[None]
    dx, dy, dz = (dirs[:, i:i + 1] for i in range(3))
    ox, oy, oz = (orig[:, i:i + 1] for i in range(3))
    v0x, v0y, v0z = (tri[..., 0, i] for i in range(3))
    e1x, e1y, e1z = (tri[..., 1, i] - tri[..., 0, i] for i in range(3))
    e2x, e2y, e2z = (tri[..., 2, i] - tri[..., 0, i] for i in range(3))
    # Moller-Trumbore (same tolerances as geometry.moller_trumbore)
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
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    del px, py, pz, sx, sy, sz, qx, qy, qz, inv_det
    tol = edge_tol(t.dtype)
    hit = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1. + tol)
    b = hit & (eid >= 0) & (t > 1e-4) & (t < 1. - 1e-4)
    if excl_ids is not None:
        b = b & ~torch.any(eid[:, :, None] == excl_ids[:, None, :], dim=-1)
    # zero-thickness materials transmit with factor exactly 1: never
    # worth a slot
    safe = torch.clamp(eid, 0, th_tri.shape[0] - 1)
    b = b & (th_tri.to(torch.float32)[safe] > 0.)
    dhx, dhy, dhz = (d_hat[:, i:i + 1] for i in range(3))
    if n_tri is None:
        # unit normals from the MT edge vectors
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        inv_len = 1. / torch.clamp(
            torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-30)
        nx, ny, nz = nx * inv_len, ny * inv_len, nz * inv_len
    else:
        nx, ny, nz = (n_tri[..., i] for i in range(3))
    cos_i = torch.abs(dhx * nx + dhy * ny + dhz * nz).to(torch.float32)
    if e_a is None:
        c = torch.ones(b.shape, dtype=torch.float32, device=b.device)
        s = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    else:
        # TE axis of each blocker within the (e_a, e_b) plane; at
        # normal incidence (|d x n| ~ 0) fall back to e_a: TE == TM
        # there, so the angle is irrelevant and (c, s) = (1, 0).
        ex = dhy * nz - dhz * ny
        ey = dhz * nx - dhx * nz
        ez = dhx * ny - dhy * nx
        s_norm = torch.sqrt(ex * ex + ey * ey + ez * ez)
        inv_n = 1. / torch.clamp(s_norm, min=1e-30)
        eax, eay, eaz = (e_a[:, i:i + 1] for i in range(3))
        ebx, eby, ebz = (e_b[:, i:i + 1] for i in range(3))
        small = s_norm <= 1e-6
        c = torch.where(small, 1., (ex * eax + ey * eay + ez * eaz)
                        * inv_n).to(torch.float32)
        s = torch.where(small, 0., (ex * ebx + ey * eby + ez * ebz)
                        * inv_n).to(torch.float32)
    return {
        "t": torch.where(b, t, torch.inf).to(torch.float32),
        "cos_i": cos_i,
        "c": c,
        "s": s,
        "eid": torch.where(b, eid, -1),
    }


def _sorted_slots(fields, k_keep):
    """Sorts slot fields ascending in t with one stable sort (ties keep
    their order, as JAX's stable ``lax.sort`` and ``lax.top_k`` do) and
    keeps the first ``k_keep``."""
    t, order = torch.sort(fields["t"], dim=1, stable=True)
    if k_keep is not None and t.shape[1] > k_keep:
        t, order = t[:, :k_keep], order[:, :k_keep]
    out = {"t": t}
    for key in _SLOT_KEYS[1:]:
        out[key] = torch.gather(fields[key], 1, order)
    return out


def sort_blocker_slots(cand, k_keep=DEFAULT_K_BLOCKERS):
    """Sorts candidate slot fields ascending in crossing parameter t
    (non-blockers carry t = +inf and sort last), keeping only the
    ``k_keep`` nearest slots (the accel path's K: each dropped slab
    factor has |t| < 1, so a path 16+ walls deep is only
    overestimated)."""
    return _sorted_slots(cand, k_keep)


def merge_blocker_slots(slots, cand):
    """Keeps the K smallest-t entries of slots ++ candidates, ascending
    in t (along-ray crossing order)."""
    k = slots["t"].shape[1]
    merged = {key: torch.cat([slots[key], cand[key]], dim=1)
              for key in _SLOT_KEYS}
    return _sorted_slots(merged, k)


def _slot_coefficients(slots, eta_tri, th_tri, lam):
    eid = slots["eid"]
    valid = eid >= 0
    safe = torch.clamp(eid, 0, eta_tri.shape[0] - 1)
    t_te, t_tm = slab_transmission(
        slots["cos_i"], eta_tri.to(torch.complex64)[safe],
        th_tri.to(torch.float32)[safe], lam)
    return valid, t_te, t_tm


def jones_from_slots(slots, eta_tri, th_tri, lam):
    """Ordered polarimetric transmission cascade of the collected
    blocker slots: [R, 2, 2] complex64. Slots are ascending in t, so
    index 0 is crossed (and applied) first."""
    valid, t_te, t_tm = _slot_coefficients(slots, eta_tri, th_tri, lam)
    one_c = torch.ones((), dtype=torch.complex64, device=valid.device)
    zero_c = torch.zeros((), dtype=torch.complex64, device=valid.device)
    t_te = torch.where(valid, t_te, one_c)
    t_tm = torch.where(valid, t_tm, one_c)
    c, s = slots["c"], slots["s"]
    cc = (c * c).to(torch.complex64)
    ss = (s * s).to(torch.complex64)
    cs = (c * s).to(torch.complex64)
    j00 = cc * t_te + ss * t_tm
    j01 = torch.where(valid, cs * (t_te - t_tm), zero_c)
    j11 = ss * t_te + cc * t_tm
    c00, c01, c10, c11 = jones_tree_prod(j00, j01, j01, j11)
    return torch.stack([torch.stack([c00, c01], -1),
                        torch.stack([c10, c11], -1)], -2)


def scalar_from_slots(slots, eta_tri, th_tri, lam):
    """Polarization-averaged transmission product of the collected
    blocker slots: [R] complex64 (commutative, order-free)."""
    valid, t_te, t_tm = _slot_coefficients(slots, eta_tri, th_tri, lam)
    one_c = torch.ones((), dtype=torch.complex64, device=valid.device)
    t_eff = torch.where(valid, 0.5 * (t_te + t_tm), one_c)
    return torch.prod(t_eff, dim=-1)


def _dense_chunks(orig, dirs, tri, max_elems):
    """Chunked triangle views for the dense sweep: (list of (tri [C, 3,
    3], normals [C, 3], ids [C]), d_hat [R, 3])."""
    num_rays = orig.shape[0]
    num_tri = tri.shape[0]
    chunk = num_tri if num_rays * num_tri <= max_elems \
        else max(64, max_elems // max(num_rays, 1))
    normals = tri_normals(tri)
    ids = torch.arange(num_tri, device=tri.device)
    chunks = [(tri[b:b + chunk], normals[b:b + chunk], ids[b:b + chunk])
              for b in range(0, num_tri, chunk)]
    d_hat = dirs / torch.clamp(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-30)
    return chunks, d_hat


def transmission_product(orig, dirs, tri, eta_tri, th_tri, lam,
                         excl_ids=None, max_elems=16_000_000,
                         accel=None):
    """Complex transmission factor of segment [orig, orig+dirs]
    through every blocking triangle (product of per-blocker slab
    coefficients, polarization-averaged), ignoring ``excl_ids``.

    Each blocker contributes the unpolarized average (t_TE + t_TM)/2 in
    its own incidence plane, so the product is a scalar and commutes:
    exact at normal incidence. For the full polarimetric cascade use
    :func:`transmission_jones_product`. With ``accel``, the query runs
    through the clustered structure (see accel.py)."""
    if accel is not None:
        from .accel import transmission_product_accel
        return transmission_product_accel(
            orig, dirs, accel, eta_tri, th_tri, lam,
            excl_ids=excl_ids)
    chunks, d_hat = _dense_chunks(orig, dirs, tri, max_elems)
    prod = None
    for tri_k, n_k, id_k in chunks:
        cand = blocker_candidates(orig, dirs, d_hat, tri_k, n_k, id_k,
                                  th_tri, excl_ids=excl_ids)
        p = scalar_from_slots(cand, eta_tri, th_tri, lam)
        prod = p if prod is None else prod * p
    return prod


def jones_tree_prod(j00, j01, j10, j11):
    """Ordered matrix product over axis 1 of per-blocker 2x2 factors
    (index 0 applied FIRST, i.e. rightmost). Matrix multiplication is
    associative, so a pairwise tree preserves the sequential result
    while vectorizing the reduction (log2 C levels)."""
    while j00.shape[1] > 1:
        c = j00.shape[1]
        if c % 2:
            def pad(x, v):
                return torch.cat(
                    [x, torch.full_like(x[:, :1], v)], dim=1)
            j00 = pad(j00, 1.)
            j11 = pad(j11, 1.)
            j01 = pad(j01, 0.)
            j10 = pad(j10, 0.)
        a00, a01 = j00[:, 0::2], j01[:, 0::2]   # earlier (right)
        a10, a11 = j10[:, 0::2], j11[:, 0::2]
        b00, b01 = j00[:, 1::2], j01[:, 1::2]   # later (left)
        b10, b11 = j10[:, 1::2], j11[:, 1::2]
        j00 = b00 * a00 + b01 * a10
        j01 = b00 * a01 + b01 * a11
        j10 = b10 * a00 + b11 * a10
        j11 = b10 * a01 + b11 * a11
    return j00[:, 0], j01[:, 0], j10[:, 0], j11[:, 0]


def transmission_jones_product(orig, dirs, tri, eta_tri, th_tri, lam,
                               e_a, e_b, excl_ids=None,
                               max_elems=16_000_000, accel=None):
    """Full polarimetric through-blocker transmission: the 2x2 Jones
    matrix cascade of per-blocker TE/TM slab coefficients along the
    segment [orig, orig+dirs], expressed in the caller's transverse
    basis (e_a, e_b) of the propagation direction.

    Each blocker k rotates the field into its own incidence plane
    (TE axis e_s = d x n / |d x n|, TM axis e_p = e_s x d), applies
    diag(t_TE, t_TM), and rotates back:

        J = prod_k R(-psi_k) diag(t_TE_k, t_TM_k) R(psi_k)

    orig/dirs: [R, 3]; e_a/e_b: [R, 3] orthonormal transverse basis.
    Returns J: [R, 2, 2] complex64.

    Both paths apply factors in along-ray crossing order: the dense
    sweep sorts each chunk's candidates by t (exact within a chunk,
    chunk-major across the rare multi-chunk case), the accel path merges
    K-nearest blocker slots. With ``accel``, the query runs through the
    clustered structure (see accel.py)."""
    if accel is not None:
        from .accel import transmission_jones_product_accel
        return transmission_jones_product_accel(
            orig, dirs, accel, eta_tri, th_tri, lam, e_a, e_b,
            excl_ids=excl_ids)
    chunks, d_hat = _dense_chunks(orig, dirs, tri, max_elems)
    jones = None
    for tri_k, n_k, id_k in chunks:
        cand = blocker_candidates(orig, dirs, d_hat, tri_k, n_k, id_k,
                                  th_tri, e_a, e_b, excl_ids)
        c = jones_from_slots(sort_blocker_slots(cand), eta_tri, th_tri,
                             lam)
        jones = c if jones is None else c @ jones
    return jones
