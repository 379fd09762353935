"""Single-bounce diffuse scattering for the path solver
(effective-roughness model, Degli-Esposti): host-side area-weighted
surface sampling plus one device evaluation of the bistatic scattered
field with per-material re-radiation lobes (see scattering_pattern.py).

PyTorch counterpart of ``sionna_tpu/rt/scattering.py``. The scatter
points come from ``np.random.default_rng(seed)`` on the host, as in the
JAX package; the random depolarizing phases come from
:func:`draw_scatter_phases` (a ``torch.Generator`` seeded from ``seed``),
a function of its own so that a caller can hand in other draws.
"""

import numpy as np
import torch

from ..phy.constants import PI, SPEED_OF_LIGHT
from .field import combine_paths
from .geometry import any_blocking_hit, phase_exp, sph_basis

__all__ = ["sample_scatter_points", "eval_scattering",
           "draw_scatter_phases"]


def sample_scatter_points(scene, scat_tri, num_samples, seed, rd):
    """Host-side area-weighted sampling of scattering surfaces.

    Returns (points [N,3], tri_idx [N], d_area) as NumPy, or None when
    no material scatters."""
    tri_np = np.asarray(scene.triangles)
    v0, v1, v2 = tri_np[:, 0], tri_np[:, 1], tri_np[:, 2]
    areas = 0.5 * np.linalg.norm(
        np.cross(v1 - v0, v2 - v0), axis=1)
    w_area = areas * (np.asarray(scat_tri) > 0.)
    total_area = float(w_area.sum())
    if total_area <= 0.:
        return None
    rng = np.random.default_rng(seed)
    tri_idx = rng.choice(tri_np.shape[0], size=num_samples,
                         p=w_area / total_area).astype(np.int32)
    r_a = np.sqrt(rng.random(num_samples))
    r_b = rng.random(num_samples)
    bary = np.stack([1. - r_a, r_a * (1. - r_b), r_a * r_b],
                    axis=1)                         # [N,3]
    p = np.einsum("nk,nkd->nd", bary, tri_np[tri_idx])
    # effective area represented by each sample (importance-
    # weighted: samples are drawn proportional to area)
    return p.astype(rd), tri_idx, total_area / num_samples


def draw_scatter_phases(seed, num_samples, num_tx, num_rx, device):
    """The uniform phases in [0, 2 pi) of the scattered paths: (chi0
    [N, tx, rx], the common phase, and chi [N, tx, rx, 2, 2], the
    depolarizing Jones matrix's), float32 on ``device``, from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    chi0 = torch.rand((num_samples, num_tx, num_rx), **f32) * (2. * PI)
    chi = torch.rand((num_samples, num_tx, num_rx, 2, 2), **f32) \
        * (2. * PI)
    return chi0, chi


def _pattern_of_triangles(scene):
    """(packed pattern table, pattern index per triangle) on the host."""
    from .scattering_pattern import LambertianPattern, pack_patterns
    default_pat = LambertianPattern()
    mats, mat_of_tri = scene.material_table()
    uniq = {}
    pat_of_mat = np.empty(len(mats), np.int32)
    uniq_pats = []
    for j, m in enumerate(mats):
        pat = getattr(m, "scattering_pattern", None) or default_pat
        can = pat.canonical()
        if can not in uniq:
            uniq[can] = len(uniq_pats)
            uniq_pats.append(pat)
        pat_of_mat[j] = uniq[can]
    return pack_patterns(uniq_pats), pat_of_mat[mat_of_tri]


def eval_scattering(scene, tri, normals, tx_pos, rx_pos, eta_tri, p,
                    tri_idx, d_area, num_samples, seed, txs, rxs,
                    th_tri=None, refraction=False, accel=None):
    """Single-bounce diffuse scattering via area-weighted Monte Carlo
    over the scene surface (effective-roughness model with per-material
    re-radiation lobes: Lambertian, directive, or backscattering).

    Each sample point p contributes mean received power
    (lam/4pi)^2 * cos(theta_i) * dA * S^2 * Gamma^2
    * f(k_i, k_s) / (r1^2 r2^2) with dA = total_area / N, energy-
    consistent with the sqrt(1-S^2) reduction the specular evaluator
    applies to reflected fields. Scattered paths are depolarized with
    uniform random phases (power-calibrated in expectation).

    p: [N, 3] tensor on the device; tri_idx: [N] host int array."""
    lam = scene.wavelength
    dev = tri.device
    mats, mat_of_tri = scene.material_table()
    scat_np = np.array([m.scattering_coefficient for m in mats],
                       np.float32)[mat_of_tri]
    s_coef = torch.as_tensor(scat_np[tri_idx], device=dev)     # [N]
    tri_idx_d = torch.as_tensor(tri_idx.astype(np.int64), device=dev)
    n_s = normals[tri_idx_d]                                   # [N,3]
    num_tx = tx_pos.shape[0]
    num_rx = rx_pos.shape[0]

    s1_vec = p[:, None] - tx_pos[None]              # [N,T,3]
    s1 = torch.linalg.norm(s1_vec, dim=-1)
    shat1 = s1_vec / torch.clamp(s1[..., None], min=1e-12)
    # orient the normal towards the TX
    flip = torch.sign(torch.sum(n_s[:, None] * (-shat1), -1))
    n_or = n_s[:, None] * torch.where(flip == 0., 1., flip)[
        ..., None]                                  # [N,T,3]
    cos_i = torch.clamp(-torch.sum(shat1 * n_or, -1), 0., 1.)  # [N,T]

    s2_vec = rx_pos[None, None] - p[:, None, None]  # [N,1,R,3]
    s2 = torch.linalg.norm(s2_vec, dim=-1)          # [N,1,R]
    shat2 = s2_vec / torch.clamp(s2[..., None], min=1e-12)
    cos_s = torch.sum(shat2 * n_or[:, :, None], -1)  # [N,T,R]
    valid = (cos_s > 1e-6) & (cos_i[:, :, None] > 1e-6) \
        & (s1[:, :, None] > 1e-3) & (s2 > 1e-3)

    eta_hit = eta_tri[tri_idx_d]                     # complex64
    cos_f = cos_i.to(torch.float32)
    sin2 = 1. - cos_f ** 2
    root = torch.sqrt(eta_hit[:, None] - sin2)
    r_s = (cos_f - root) / (cos_f + root)
    r_p = (eta_hit[:, None] * cos_f - root) \
        / (eta_hit[:, None] * cos_f + root)
    gamma2 = 0.5 * (torch.abs(r_s) ** 2
                    + torch.abs(r_p) ** 2)            # [N,T]

    # Re-radiation pattern f(k_i, k_s): per-material lobes, batched over
    # the mixed-material sample set through host-gathered coefficient
    # tables (see scattering_pattern.py)
    packed, pat_of_tri = _pattern_of_triangles(scene)
    sel = pat_of_tri[tri_idx]                       # [N] host
    # cos_s < 0 (RX behind the surface) is invalidated by `valid`;
    # clip here so a2 stays >= 0 and sqrt(2*a2) cannot produce a NaN
    # that would survive the multiplicative valid mask.
    cos_s_pos = torch.clamp(cos_s, 0., 1.)
    if bool(packed["is_lamb"].all()):
        f_pat = cos_s_pos / PI
    else:
        def table(key):
            return torch.as_tensor(packed[key][sel], device=dev)
        lam_w, a_r, a_i = table("lambda_"), table("a_r"), table("a_i")
        br, bi = table("Br"), table("Bi")           # [N, W]
        is_lamb = table("is_lamb")
        sin2_i = 1. - cos_f ** 2                    # [N,T]
        n_w = br.shape[-1]
        powers = torch.stack(
            [sin2_i ** w for w in range(n_w)], -1)  # [N,T,W]
        norm_r = (table("Ar")[:, None] + cos_f
                  * torch.einsum("nw,ntw->nt", br, powers))
        norm_i = (table("Ai")[:, None] + cos_f
                  * torch.einsum("nw,ntw->nt", bi, powers))
        dot_in = torch.sum(shat1 * n_or, -1, keepdim=True)  # [N,T,1]
        k_r = shat1 - 2. * dot_in * n_or            # [N,T,3]
        cos_pr = torch.clamp(
            torch.sum(k_r[:, :, None] * shat2, -1), -1., 1.)
        cos_pi = torch.clamp(
            -torch.sum(shat1[:, :, None] * shat2, -1), -1., 1.)
        f_dir = (lam_w[:, None, None]
                 * ((1. + cos_pr) / 2.) ** a_r[:, None, None]
                 / torch.clamp(norm_r[:, :, None], min=1e-12)
                 + (1. - lam_w)[:, None, None]
                 * ((1. + cos_pi) / 2.) ** a_i[:, None, None]
                 / torch.clamp(norm_i[:, :, None], min=1e-12))
        f_pat = torch.where(is_lamb[:, None, None], cos_s_pos / PI, f_dir)
    a2 = ((lam / (4. * PI)) ** 2
          * cos_i[:, :, None] * d_area
          * (s_coef[:, None] ** 2 * gamma2)[:, :, None] * f_pat
          / torch.clamp((s1[:, :, None] * s2) ** 2, min=1e-12))
    a2 = torch.where(valid, a2, 0.)
    total_len = s1[:, :, None] + s2                 # [N,T,R]
    # factor 2: E|Fr^T J Ft|^2 = 1/2 |Fr|^2 |Ft|^2 for the random
    # depolarizing Jones matrix below
    chi0, chi = draw_scatter_phases(seed, num_samples, num_tx, num_rx,
                                    dev)
    amp = (torch.sqrt(2. * a2).to(torch.float32)
           * torch.exp(1j * chi0) * phase_exp(total_len, lam))
    jones = torch.exp(1j * chi) / np.float32(np.sqrt(2.))

    # occlusion of both segments, excluding the sampled triangle
    shape3 = (num_samples, num_tx, num_rx, 3)
    excl_b = tri_idx_d[:, None, None, None].expand(
        num_samples, num_tx, num_rx, 1).reshape(-1, 1)
    o1 = tx_pos[None, :, None].expand(shape3).reshape(-1, 3)
    d1 = (-s1_vec[:, :, None]).expand(shape3).reshape(-1, 3)
    o2 = p[:, None, None].expand(shape3).reshape(-1, 3)
    d2 = s2_vec.expand(shape3).reshape(-1, 3)
    if refraction:
        # Full polarimetric through-blocker cascade (as in the specular
        # and diffraction stages): segment-1 factors in the spherical
        # basis of the departure direction shat1, segment-2 factors in
        # the arrival basis of u_r = -shat2, the bases combine_paths
        # contracts the Jones matrix with.
        from .em import transmission_jones_product
        e_th1, e_ph1 = sph_basis(shat1)             # [N,T,3]
        ea1 = e_th1[:, :, None].expand(shape3).reshape(-1, 3)
        eb1 = e_ph1[:, :, None].expand(shape3).reshape(-1, 3)
        e_th2, e_ph2 = sph_basis(-shat2)            # [N,1,R,3]
        ea2 = e_th2.expand(shape3).reshape(-1, 3)
        eb2 = e_ph2.expand(shape3).reshape(-1, 3)
        jt1 = transmission_jones_product(
            o1, -d1, tri, eta_tri, th_tri, lam, ea1, eb1,
            excl_ids=excl_b, accel=accel)
        jt2 = transmission_jones_product(
            o2, d2, tri, eta_tri, th_tri, lam, ea2, eb2,
            excl_ids=excl_b, accel=accel)
        jones = (jt2.reshape(num_samples, num_tx, num_rx, 2, 2)
                 @ jones
                 @ jt1.reshape(num_samples, num_tx, num_rx, 2, 2))
    else:
        blocked1 = any_blocking_hit(o1, -d1, tri,
                                    excl_ids=excl_b, accel=accel)
        blocked2 = any_blocking_hit(o2, d2, tri,
                                    excl_ids=excl_b, accel=accel)
        valid = valid & ~(blocked1 | blocked2).reshape(
            num_samples, num_tx, num_rx)

    d0_hat = shat1[:, :, None].expand(shape3)
    u_r = (-shat2).expand(shape3)
    tau = total_len / SPEED_OF_LIGHT
    return combine_paths(scene, txs, rxs, d0_hat, u_r, jones, amp,
                         valid, tau)
