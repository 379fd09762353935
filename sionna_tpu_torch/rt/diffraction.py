"""First-order wedge diffraction for the path solver.

PyTorch counterpart of ``sionna_tpu/rt/diffraction.py``: the uniform
theory of diffraction (UTD, Kouyoumjian-Pathak 1974) with the Luebbers
(1984) heuristic extension to finitely conducting wedges. Wedge
extraction is a one-time host-side NumPy pass over the triangle soup (a
copy of the JAX package's); the per-(wedge, tx, rx) evaluation is one
batch of elementwise math on the device (closed-form diffraction point,
Fresnel transition function in float64).
"""

import math as _math

import numpy as np
import torch

from ..phy.constants import PI, SPEED_OF_LIGHT

__all__ = ["extract_wedges", "fresnel_transition", "eval_diffraction"]

_SQRT_HALF_PI = np.sqrt(np.pi / 2.)


# ----------------------------------------------------------------------
# Host-side wedge extraction
# ----------------------------------------------------------------------
def extract_wedges(triangles, tol=1e-6, angle_tol=1e-3):
    """Extracts diffracting wedges from a triangle soup.

    A wedge is an edge shared by exactly two non-coplanar triangles
    (exterior angle ``n*pi`` with ``n`` in (1, 2)), or a boundary edge
    of a single triangle (a screen edge, ``n = 2``).  The smaller
    sector between the two face tangents is taken as the solid — this
    makes the wedge exterior always the convex side, which is exactly
    where diffraction is physical: positions inside the concave sector
    of an interior corner fall outside [0, n*pi] and produce no paths,
    while thin-sheet corners (no solid at all) diffract on their
    convex side.  Works for triangle soups with arbitrary winding.

    Returns a dict of NumPy arrays, all leading dim [W]:
      origin [W,3], e_hat [W,3], length [W],
      x_hat [W,3]  (0-face tangent: phi is measured from it),
      y_hat [W,3]  (0-face normal into the exterior),
      n_angle [W]  (exterior wedge angle in radians, in (pi, 2*pi]),
      tri_0 [W], tri_n [W]  (face triangle ids; tri_n = tri_0 for
                             screen edges).
    """
    tri = np.asarray(triangles, np.float64)
    empty = {
        "origin": np.zeros((0, 3)), "e_hat": np.zeros((0, 3)),
        "length": np.zeros((0,)), "x_hat": np.zeros((0, 3)),
        "y_hat": np.zeros((0, 3)), "n_angle": np.zeros((0,)),
        "tri_0": np.zeros((0,), np.int64),
        "tri_n": np.zeros((0,), np.int64),
    }
    num_tri = tri.shape[0]
    if num_tri == 0:
        return empty

    # Canonical vertex ids (merge vertices within tolerance)
    verts = tri.reshape(-1, 3)
    vkey = np.round(verts / tol).astype(np.int64)
    uniq_keys, inv = np.unique(vkey, axis=0, return_inverse=True)
    # representative coordinates per canonical vertex
    rep = np.zeros((uniq_keys.shape[0], 3))
    rep[inv] = verts
    vid = inv.reshape(num_tri, 3)                      # [T, 3]

    # All directed edges with owning triangle and opposite vertex
    pair_cols = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    edges = np.concatenate(
        [np.stack([vid[:, a], vid[:, b]], axis=1)
         for a, b, _ in pair_cols], axis=0)            # [3T, 2]
    owner = np.concatenate([np.arange(num_tri)] * 3)
    opp = np.concatenate([vid[:, c] for _, _, c in pair_cols])

    ekey = np.sort(edges, axis=1)
    uniq_e, inverse, counts = np.unique(
        ekey, axis=0, return_inverse=True, return_counts=True)

    order = np.argsort(inverse, kind="stable")
    inv_sorted = inverse[order]
    starts = np.searchsorted(inv_sorted, np.arange(uniq_e.shape[0]))

    w = {k: [] for k in empty}

    def _face_frame(eid, tri_id, opp_v):
        p0 = rep[uniq_e[eid, 0]]
        p1 = rep[uniq_e[eid, 1]]
        e_vec = p1 - p0
        e_len = np.linalg.norm(e_vec)
        if e_len < tol:
            return None
        e_hat = e_vec / e_len
        o = rep[opp_v] - p0
        t_face = o - np.dot(o, e_hat) * e_hat
        tn = np.linalg.norm(t_face)
        if tn < tol:
            return None
        t_face = t_face / tn
        # winding normal of the owning triangle
        a, b, c = tri[tri_id]
        nrm = np.cross(b - a, c - a)
        nn = np.linalg.norm(nrm)
        nrm = nrm / nn if nn > 0 else nrm
        return p0, e_hat, e_len, t_face, nrm

    for eid in range(uniq_e.shape[0]):
        cnt = counts[eid]
        if cnt > 2:          # non-manifold edge: skip
            continue
        rows = order[starts[eid]:starts[eid] + cnt]
        fr0 = _face_frame(eid, owner[rows[0]], opp[rows[0]])
        if fr0 is None:
            continue
        p0, e_hat, e_len, t0, n0 = fr0
        if cnt == 1:
            # screen edge: both faces coincide, exterior angle 2*pi
            w["origin"].append(p0)
            w["e_hat"].append(e_hat)
            w["length"].append(e_len)
            w["x_hat"].append(t0)
            w["y_hat"].append(n0)
            w["n_angle"].append(2. * np.pi)
            w["tri_0"].append(owner[rows[0]])
            w["tri_n"].append(owner[rows[0]])
            continue
        frn = _face_frame(eid, owner[rows[1]], opp[rows[1]])
        if frn is None:
            continue
        _, _, _, tn_, _ = frn
        cosg = np.clip(np.dot(t0, tn_), -1., 1.)
        gamma = np.arccos(cosg)   # angle between tangents, in [0, pi]
        if gamma > np.pi - angle_tol or gamma < angle_tol:
            continue              # coplanar continuation / degenerate
        # 0-face frame: y_hat = outward normal of face 0 (flip so the
        # n-face tangent lies behind it, i.e. in the solid half)
        y_hat = n0 if np.dot(n0, tn_) < 0 else -n0
        # exterior angle: angle of t_n measured from t0 through the
        # exterior (the side y_hat points into)
        ang = np.arctan2(np.dot(tn_, y_hat), np.dot(tn_, t0))
        n_angle = ang % (2. * np.pi)
        if n_angle <= np.pi + angle_tol:
            continue              # numerically concave: skip
        w["origin"].append(p0)
        w["e_hat"].append(e_hat)
        w["length"].append(e_len)
        w["x_hat"].append(t0)
        w["y_hat"].append(y_hat)
        w["n_angle"].append(n_angle)
        w["tri_0"].append(owner[rows[0]])
        w["tri_n"].append(owner[rows[1]])

    if not w["origin"]:
        return empty
    return {
        "origin": np.asarray(w["origin"]),
        "e_hat": np.asarray(w["e_hat"]),
        "length": np.asarray(w["length"]),
        "x_hat": np.asarray(w["x_hat"]),
        "y_hat": np.asarray(w["y_hat"]),
        "n_angle": np.asarray(w["n_angle"]),
        "tri_0": np.asarray(w["tri_0"], np.int64),
        "tri_n": np.asarray(w["tri_n"], np.int64),
    }


# ----------------------------------------------------------------------
# Fresnel transition function
# ----------------------------------------------------------------------
# power-series coefficients: C = u sum_k (-1)^k x^{2k}/((2k)!(4k+1)),
# S = u sum_k (-1)^k x^{2k+1}/((2k+1)!(4k+3)), x = pi u^2 / 2
_SER_K = np.arange(30)
_SER_SIGN = (-1.0) ** _SER_K
_SER_C = np.array([1. / float(_math.factorial(2 * k)
                              * (4 * k + 1))
                   for k in range(len(_SER_K))],
                  np.float64) * _SER_SIGN
_SER_S = np.array([1. / float(_math.factorial(2 * k + 1)
                              * (4 * k + 3))
                   for k in range(len(_SER_K))],
                  np.float64) * _SER_SIGN
_SER_SPLIT = 3.2          # series for |u| <= 3.2, asymptotic beyond


def _fresnel_cs(u):
    """Fresnel integrals C(u), S(u) (A&S 7.3.1-2 convention, integrand
    cos/sin(pi t^2 / 2)), accurate to ~1e-7: power series for small
    arguments, A&S 7.3.27-28 asymptotic auxiliary functions beyond
    (evaluated in float64)."""
    au = torch.abs(u).to(torch.float64)
    f64 = dict(dtype=torch.float64, device=u.device)
    x = 0.5 * PI * au * au
    # --- power series (clamped so the unused branch cannot overflow)
    xs = torch.clamp(x, max=0.5 * PI * _SER_SPLIT ** 2)
    p = xs[..., None] ** torch.as_tensor(2 * _SER_K, **f64)  # [..., K]
    c_ser = au * torch.sum(p * torch.as_tensor(_SER_C, **f64), dim=-1)
    s_ser = au * xs * torch.sum(p * torch.as_tensor(_SER_S, **f64),
                                dim=-1)
    # --- asymptotic auxiliary functions f, g (A&S 7.3.27-28)
    pz = torch.clamp(PI * au * au, min=1e-30)
    pz2 = pz * pz
    f_asy = (1. - 3. / pz2 + 105. / pz2 ** 2
             - 10395. / pz2 ** 3) / (PI * torch.clamp(au, min=1e-30))
    g_asy = (1. - 15. / pz2 + 945. / pz2 ** 2
             - 135135. / pz2 ** 3) / (PI * torch.clamp(au, min=1e-30)
                                      * pz)
    sin_x, cos_x = torch.sin(x), torch.cos(x)
    c_asy = 0.5 + f_asy * sin_x - g_asy * cos_x
    s_asy = 0.5 - f_asy * cos_x - g_asy * sin_x
    small = au <= _SER_SPLIT
    c = torch.where(small, c_ser, c_asy)
    s = torch.where(small, s_ser, s_asy)
    sgn = torch.sign(u).to(torch.float64)
    return sgn * c, sgn * s


def fresnel_transition(x):
    """UTD Fresnel transition function
    F(x) = 2j sqrt(x) e^{jx} \\int_{sqrt(x)}^inf e^{-j tau^2} dtau,
    elementwise over ``x >= 0``. F(x) -> 1 for large x and
    F(x) ~ sqrt(pi x) e^{j(pi/4 + x)} for x -> 0.

    Returns complex64 (real internals in float64)."""
    x = torch.clamp(x, min=0.).to(torch.float64)
    u = torch.sqrt(2. * x / PI)
    c, s = _fresnel_cs(u)
    re = (_SQRT_HALF_PI * (0.5 - c)).to(torch.float32)
    im = (-_SQRT_HALF_PI * (0.5 - s)).to(torch.float32)
    integral = torch.complex(re, im)              # complex64
    mag = (2. * torch.sqrt(x)).to(torch.float32)
    # e^{j(x + pi/2)}: fold the 2j prefactor into the phase; reduce
    # x mod 2 pi in float64 first so large arguments keep phase
    ang = (torch.remainder(x / (2. * PI), 1.) * (2. * PI)
           + 0.5 * PI).to(torch.float32)
    return mag * torch.exp(1j * ang) * integral


# ----------------------------------------------------------------------
# UTD diffraction coefficients and path evaluation
# ----------------------------------------------------------------------
_EXP_P4 = complex(np.complex64(np.exp(1j * np.pi / 4.)))


def _cot_f_term(beta, n, k_l, sign):
    """One cotangent term of the UTD coefficient:
    cot((pi + sign*beta) / (2n)) * F(k L a^{sign}(beta)) with the
    Kouyoumjian-Pathak finite limit at shadow/reflection boundaries.
    Complex math stays in complex64."""
    two_n_pi = 2. * n * PI
    big_n = torch.round((sign * beta + PI) / two_n_pi)
    a = 2. * torch.cos((two_n_pi * big_n - sign * beta) / 2.) ** 2
    arg = (PI + sign * beta) / (2. * n)
    sin_arg = torch.sin(arg)
    safe = torch.abs(sin_arg) > 1e-5
    cot = torch.where(safe, torch.cos(arg) / torch.where(safe, sin_arg, 1.),
                      0.)
    term = cot.to(torch.float32) * fresnel_transition(k_l * a)
    # K-P limit as the cot argument crosses a multiple of pi:
    # eps = pi + sign*beta - 2 n pi N  ->  n e^{j pi/4}
    #   [ sqrt(2 pi k L) sgn(eps) - 2 k L eps e^{j pi/4} ]
    eps = PI + sign * beta - two_n_pi * big_n
    sgn_eps = torch.where(eps >= 0., 1., -1.)
    lim_a = (n * torch.sqrt(2. * PI * k_l) * sgn_eps).to(torch.float32)
    lim_b = (2. * n * k_l * eps).to(torch.float32)
    limit = _EXP_P4 * (lim_a - lim_b * _EXP_P4)
    return torch.where(safe, term, limit.to(torch.complex64))


def _fresnel_refl(eta, cos_i):
    """Fresnel reflection coefficients (r_s TE, r_p TM) for complex
    relative permittivity ``eta`` at incidence cosine ``cos_i``
    (measured from the surface normal). complex64 throughout."""
    eta = eta.to(torch.complex64)
    cos_i = cos_i.to(torch.float32)
    sin2 = 1. - cos_i ** 2
    root = torch.sqrt(eta - sin2)
    r_s = (cos_i - root) / (cos_i + root)
    r_p = (eta * cos_i - root) / (eta * cos_i + root)
    return r_s, r_p


def utd_coefficients(phi, phi_p, n, k_l, sin_b0, k_wave, eta_0, eta_n):
    """Heuristic UTD diffraction coefficients (D_s, D_h) for a lossy
    wedge (Luebbers 1984; reduces to Kouyoumjian-Pathak for PEC).

    All inputs broadcast elementwise. ``n`` is the exterior angle / pi;
    ``k_l`` is k * L with L the distance parameter; ``eta_0`` /
    ``eta_n`` the complex permittivities of the 0- and n-face."""
    beta_m = phi - phi_p
    beta_p = phi + phi_p
    t1 = _cot_f_term(beta_m, n, k_l, +1.)
    t2 = _cot_f_term(beta_m, n, k_l, -1.)
    t3 = _cot_f_term(beta_p, n, k_l, -1.)
    t4 = _cot_f_term(beta_p, n, k_l, +1.)
    # Reflection coefficients at the grazing-referenced angles: the
    # 0-face sees the incident ray at grazing angle phi', the n-face
    # the diffracted ray at (n pi - phi).
    r0_s, r0_p = _fresnel_refl(eta_0, torch.sin(phi_p))
    rn_s, rn_p = _fresnel_refl(eta_n, torch.sin(n * PI - phi))
    pref_mag = (-1. / (2. * n * np.sqrt(2. * PI * k_wave)
                       * torch.clamp(sin_b0, min=1e-6))
                ).to(torch.float32)
    pref = pref_mag * _EXP_P4.conjugate()     # -e^{-j pi/4} / (...)
    d_s = pref * (t1 + t2 + r0_s * t3 + rn_s * t4)
    d_h = pref * (t1 + t2 + r0_p * t3 + rn_p * t4)
    return d_s, d_h


# ----------------------------------------------------------------------
# Batched first-order UTD evaluation (device stage)
# ----------------------------------------------------------------------
def eval_diffraction(scene, tri, wedges, tx_pos, rx_pos, eta_tri,
                     txs, rxs, th_tri=None, refraction=False,
                     accel=None):
    """Evaluates first-order UTD diffraction off every wedge for all
    TX/RX pairs as one [W, tx, rx] batch.

    ``wedges`` holds the host arrays of :func:`extract_wedges` (real
    ones already in the geometry dtype). The diffraction point on each
    (straight) edge follows from the generalized Fermat principle in
    closed form: with (t, rho) the cylindrical coordinates of TX/RX
    about the edge line, the stationary point is t_d = (t_tx rho_rx +
    t_rx rho_tx) / (rho_tx + rho_rx), which also satisfies the Keller
    cone condition beta_0 = beta_0'."""
    from .field import combine_paths
    from .geometry import any_blocking_hit, phase_exp, sph_basis

    dev = tri.device
    lam = scene.wavelength
    k_wave = 2. * PI / lam

    def t(key):
        return torch.as_tensor(wedges[key], device=dev)

    origin = t("origin")                            # [W,3]
    e_hat = t("e_hat")
    e_len = t("length")                             # [W]
    x_hat = t("x_hat")
    y_hat = t("y_hat")
    n_ang = t("n_angle")                            # [W]
    tri_0 = torch.as_tensor(wedges["tri_0"].astype(np.int64), device=dev)
    tri_n = torch.as_tensor(wedges["tri_n"].astype(np.int64), device=dev)
    eta0 = eta_tri[tri_0]
    etan = eta_tri[tri_n]
    num_w = origin.shape[0]
    num_tx = tx_pos.shape[0]
    num_rx = rx_pos.shape[0]

    # cylindrical coordinates about the edge line
    rel_t = tx_pos[None] - origin[:, None]          # [W,T,3]
    t1 = torch.sum(rel_t * e_hat[:, None], -1)      # [W,T]
    perp_t = rel_t - t1[..., None] * e_hat[:, None]
    rho1 = torch.linalg.norm(perp_t, dim=-1)
    rel_r = rx_pos[None] - origin[:, None]          # [W,R,3]
    t2 = torch.sum(rel_r * e_hat[:, None], -1)
    perp_r = rel_r - t2[..., None] * e_hat[:, None]
    rho2 = torch.linalg.norm(perp_r, dim=-1)

    denom = rho1[:, :, None] + rho2[:, None]
    t_d = (t1[:, :, None] * rho2[:, None]
           + t2[:, None] * rho1[:, :, None]) \
        / torch.clamp(denom, min=1e-12)             # [W,T,R]
    valid = ((t_d > 1e-6)
             & (t_d < e_len[:, None, None] - 1e-6)
             & (rho1[:, :, None] > 1e-4)
             & (rho2[:, None, :] > 1e-4))
    q = origin[:, None, None] \
        + t_d[..., None] * e_hat[:, None, None]     # [W,T,R,3]
    s_i_vec = q - tx_pos[None, :, None]
    s_i = torch.linalg.norm(s_i_vec, dim=-1)
    shat_i = s_i_vec / torch.clamp(s_i[..., None], min=1e-12)
    s_d_vec = rx_pos[None, None] - q
    s_d = torch.linalg.norm(s_d_vec, dim=-1)
    shat_d = s_d_vec / torch.clamp(s_d[..., None], min=1e-12)

    # azimuths about the edge, measured from the 0-face through the
    # exterior region
    u_p = perp_t / torch.clamp(rho1[..., None], min=1e-12)
    phi_p = torch.remainder(torch.arctan2(
        torch.sum(u_p * y_hat[:, None], -1),
        torch.sum(u_p * x_hat[:, None], -1)), 2. * PI)  # [W,T]
    u_d = perp_r / torch.clamp(rho2[..., None], min=1e-12)
    phi = torch.remainder(torch.arctan2(
        torch.sum(u_d * y_hat[:, None], -1),
        torch.sum(u_d * x_hat[:, None], -1)), 2. * PI)  # [W,R]
    valid = valid & (phi_p[:, :, None] <= n_ang[:, None, None]) \
        & (phi[:, None, :] <= n_ang[:, None, None])

    cos_b = torch.sum(e_hat[:, None, None] * shat_i, -1)
    sin_b0 = torch.sqrt(torch.clamp(1. - cos_b ** 2, min=1e-12))
    valid = valid & (sin_b0 > 1e-3)
    l_par = s_i * s_d * sin_b0 ** 2 \
        / torch.clamp(s_i + s_d, min=1e-12)
    n_par = (n_ang / PI)[:, None, None]
    d_s, d_h = utd_coefficients(
        phi[:, None, :], phi_p[:, :, None], n_par,
        k_wave * l_par, sin_b0, k_wave,
        eta0[:, None, None], etan[:, None, None])

    # edge-fixed polarization bases (McNamara convention)
    e_b = e_hat[:, None, None].expand(shat_i.shape)
    cr_i = torch.linalg.cross(e_b, shat_i)
    phi_hat_i = -cr_i / torch.clamp(
        torch.linalg.norm(cr_i, dim=-1, keepdim=True), min=1e-12)
    beta_hat_i = torch.linalg.cross(phi_hat_i, shat_i)
    cr_d = torch.linalg.cross(e_b, shat_d)
    phi_hat_d = cr_d / torch.clamp(
        torch.linalg.norm(cr_d, dim=-1, keepdim=True), min=1e-12)
    beta_hat_d = torch.linalg.cross(phi_hat_d, shat_d)

    e_th_i, e_ph_i = sph_basis(shat_i)
    rot_in = torch.stack(
        [torch.stack([torch.sum(beta_hat_i * e_th_i, -1),
                      torch.sum(beta_hat_i * e_ph_i, -1)], -1),
         torch.stack([torch.sum(phi_hat_i * e_th_i, -1),
                      torch.sum(phi_hat_i * e_ph_i, -1)], -1)],
        dim=-2).to(torch.complex64)
    u_r = -shat_d
    e_tr, e_pr = sph_basis(u_r)
    proj = torch.stack(
        [torch.stack([torch.sum(e_tr * beta_hat_d, -1),
                      torch.sum(e_tr * phi_hat_d, -1)], -1),
         torch.stack([torch.sum(e_pr * beta_hat_d, -1),
                      torch.sum(e_pr * phi_hat_d, -1)], -1)],
        dim=-2).to(torch.complex64)
    zero = torch.zeros_like(d_s, dtype=torch.complex64)
    dmat = torch.stack(
        [torch.stack([-d_s.to(torch.complex64), zero], -1),
         torch.stack([zero, -d_h.to(torch.complex64)], -1)], -2)
    jones = proj @ dmat @ rot_in

    # spreading for a straight edge with spherical incidence
    total_len = s_i + s_d
    spread = torch.sqrt(1. / torch.clamp(s_i * s_d * total_len,
                                         min=1e-12))
    amp = ((lam / (4. * PI) * spread).to(torch.float32)
           * phase_exp(total_len, lam))

    # occlusion of both segments (the wedge faces are excluded: Q lies
    # exactly on them); with refraction, blockers instead apply their
    # per-polarization TE/TM slab coefficients as 2x2 Jones factors in
    # the segment's frame (the same cascade as the specular stage), on
    # the incident spherical basis (e_th_i, e_ph_i) before the
    # diffraction matrix and on the arrival basis (e_tr, e_pr) after it
    excl_b = torch.stack([tri_0, tri_n], dim=1)[:, None, None].expand(
        num_w, num_tx, num_rx, 2).reshape(-1, 2)
    o1 = tx_pos[None, :, None].expand(q.shape).reshape(-1, 3)
    if refraction:
        from .em import transmission_jones_product
        jt1 = transmission_jones_product(
            o1, s_i_vec.reshape(-1, 3), tri, eta_tri, th_tri,
            lam, e_th_i.reshape(-1, 3), e_ph_i.reshape(-1, 3),
            excl_ids=excl_b, accel=accel)
        jt2 = transmission_jones_product(
            q.reshape(-1, 3), s_d_vec.reshape(-1, 3), tri,
            eta_tri, th_tri, lam, e_tr.reshape(-1, 3),
            e_pr.reshape(-1, 3), excl_ids=excl_b, accel=accel)
        jones = (jt2.reshape(num_w, num_tx, num_rx, 2, 2) @ jones
                 @ jt1.reshape(num_w, num_tx, num_rx, 2, 2))
    else:
        blocked1 = any_blocking_hit(
            o1, s_i_vec.reshape(-1, 3), tri,
            excl_ids=excl_b, accel=accel)
        blocked2 = any_blocking_hit(
            q.reshape(-1, 3), s_d_vec.reshape(-1, 3), tri,
            excl_ids=excl_b, accel=accel)
        valid = valid & ~(blocked1 | blocked2).reshape(
            num_w, num_tx, num_rx)

    tau = total_len / SPEED_OF_LIGHT
    return combine_paths(scene, txs, rxs, shat_i, u_r, jones, amp,
                         valid, tau)
