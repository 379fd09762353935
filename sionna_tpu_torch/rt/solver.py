"""Path solver: shoot-and-bounce candidate discovery plus exact
image-method refinement (API parity with sionna.rt.PathSolver / Paths).

PyTorch counterpart of ``sionna_tpu/rt/solver.py``. A solve moves the
scene's host geometry to the solver's device once, then runs there:
ray tracing and the on-device prefix dedupe (geometry.py, accel.py for
large scenes), the image method over every (sequence, tx, rx)
combination, occlusion or through-blocker transmission (em.py), the
polarized Fresnel cascade and the antenna/Doppler combine (field.py),
the optional diffraction and diffuse stages, and the duplicate-path
pass. The host steps of a solve are the per-depth counts of unique
sequences read back after the trace, and ``extract_wedges`` (host NumPy)
for diffraction; the acceleration structure's queries and the solver's
valid-pair compactions synchronise with the host to size their work.

Module layout (as in the JAX package):
- geometry.py   ray/triangle primitives, tracing, dedupe
- accel.py      clustered acceleration structure for large scenes
- em.py         Fresnel / slab / through-blocker transmission algebra
- field.py      antenna/Doppler/array combination stage
- diffraction.py wedge extraction + UTD coefficients + evaluator
- scattering.py  surface sampling + diffuse evaluator
- paths.py      the Paths container
This file keeps candidate discovery, the specular image-method
evaluator, and orchestration.
"""

import numpy as np
import torch

from ..phy.constants import PI, SPEED_OF_LIGHT
from .accel import build_accel, transmission_jones_product_accel
from .diffraction import extract_wedges, eval_diffraction
from .em import fresnel_coefficients, transmission_jones_product
from .field import combine_paths
from .geometry import (any_blocking_hit, fibonacci_sphere, in_triangle,
                       lexsort_rows, phase_exp, real_dtype, resolve_device,
                       sph_basis, trace_unique, tri_normals)
from .paths import Paths
from .scattering import sample_scatter_points, eval_scattering

__all__ = ["PathSolver", "Paths"]

# Scenes with at least this many triangles get the clustered
# acceleration structure (native C++ build + dense cluster culling,
# see accel.py); smaller scenes stay on the plain dense sweep whose
# fixed overhead is lower.
ACCEL_MIN_TRIS = 2048

# Pair count above which the gain output path compacts valid
# (sequence, tx, rx) pairs before the EM tail (see _eval_sequences).
GAIN_COMPACT_MIN_PAIRS = 65536


def _uniform_devices(devs):
    """True when all devices share orientation and velocity (host
    check); radio-map cell receivers always do."""
    o = np.stack([np.asarray(d.orientation) for d in devs])
    v = np.stack([np.asarray(d.velocity) for d in devs])
    return bool(np.all(o == o[:1]) and np.all(v == v[:1]))


def _gain(a):
    """Incoherent per-link gain sum_p |a[rx, 0, tx, 0, p]|^2 (element
    (0, 0) of the antenna pair): [rx, tx]."""
    return torch.sum(torch.abs(a[:, 0, :, 0, :]) ** 2, dim=-1)


# ----------------------------------------------------------------------
# Path solver
# ----------------------------------------------------------------------
class PathSolver:
    """Computes propagation paths between all scene transmitters and
    receivers: LoS, up to ``max_depth`` specular reflections,
    transmission through blocking surfaces (``refraction=True``,
    default: blocked LoS/specular segments are attenuated by the ITU-R
    P.2040 slab coefficient of each blocker instead of discarded), and
    optionally first-order UTD wedge diffraction (``diffraction=True``)
    and single-bounce diffuse scattering (``diffuse_reflection=True``,
    requires materials with a nonzero ``scattering_coefficient``). With
    refraction enabled, diffracted and scattered path segments are
    attenuated through blockers the same way.

    ``device`` (default ``config.device``, the card) is where the solve
    runs and where the returned tensors live.

    Call: solver(scene, max_depth=3, max_num_paths_per_src=100000,
    samples_per_src=20000, los=True, specular_reflection=True,
    refraction=True, diffraction=False, diffuse_reflection=False,
    diffuse_samples=4096, max_num_wedges=20000, seed=41) -> Paths.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._accel = None

    def _setup(self, scene):
        """Devices, host dtype and the scene's geometry on the device."""
        tx_names = list(scene.transmitters)
        rx_names = list(scene.receivers)
        if not tx_names or not rx_names:
            raise ValueError(
                "The scene must contain at least one transmitter and "
                "one receiver")
        txs = [scene.transmitters[n] for n in tx_names]
        rxs = [scene.receivers[n] for n in rx_names]
        if scene.tx_array is None or scene.rx_array is None:
            raise ValueError(
                "scene.tx_array and scene.rx_array must be set")
        dev = self.device
        rd = np.float64 if real_dtype(dev) == torch.float64 \
            else np.float32
        tri_np = scene.triangles.astype(rd)
        tri = torch.as_tensor(tri_np, device=dev)
        normals = tri_normals(tri) if scene.num_triangles > 0 else None
        # Clustered acceleration structure for large scenes (cached
        # per geometry fingerprint; native C++ builder, see accel.py).
        self._accel = (build_accel(tri_np, dev)
                       if scene.num_triangles >= ACCEL_MIN_TRIS else None)
        tx_pos = torch.as_tensor(
            np.stack([t.position for t in txs]).astype(rd), device=dev)
        rx_pos = torch.as_tensor(
            np.stack([r.position for r in rxs]).astype(rd), device=dev)
        return txs, rxs, rd, tri, normals, tx_pos, rx_pos

    def _materials(self, scene, rd):
        """Per-triangle (eta complex64, scattering coefficient, thickness
        float32) on the device (one entry for an empty scene)."""
        dev = self.device
        freq = scene.frequency
        if scene.num_triangles > 0:
            mats, idx = scene.material_table()
            eta = np.array([m.complex_relative_permittivity(freq)
                            for m in mats], np.complex64)[idx]
            scat = np.array([m.scattering_coefficient for m in mats],
                            rd)[idx]
            th = np.array([m.thickness for m in mats], np.float32)[idx]
        else:
            eta = np.ones(1, np.complex64)
            scat = np.zeros(1, rd)
            th = np.zeros(1, np.float32)
        return (torch.as_tensor(eta, device=dev),
                torch.as_tensor(scat, device=dev),
                torch.as_tensor(th, device=dev))

    def _candidates(self, tri, normals, tx_pos, max_depth,
                    samples_per_src, max_num_paths_per_src):
        """Unique reflection sequences of each depth, shortest first and
        capped at ``max_num_paths_per_src`` in all: all tx sources traced
        as one ray batch with the prefix dedupe on the device, then the
        per-depth counts read back to the host (a host step)."""
        dev = self.device
        dirs = torch.as_tensor(fibonacci_sphere(samples_per_src),
                               dtype=tri.dtype, device=dev)
        num_t = tx_pos.shape[0]
        orig = tx_pos[:, None, :].expand(num_t, samples_per_src, 3) \
            .reshape(-1, 3)
        dirs_all = dirs[None].expand(num_t, samples_per_src, 3) \
            .reshape(-1, 3)
        cap = int(min(max_num_paths_per_src, num_t * samples_per_src))
        uniq, counts = trace_unique(tri, normals, orig, dirs_all,
                                    max_depth, cap, self._accel)
        counts = counts.tolist()
        sequences = []
        budget = max_num_paths_per_src
        for d in range(1, max_depth + 1):
            if budget <= 0:
                break
            n = int(min(counts[d - 1], budget))
            if n == 0:
                continue
            budget -= n
            sequences.append(uniq[d - 1][:n])
        return sequences

    def __call__(self, scene, max_depth=3,
                 max_num_paths_per_src=100000,
                 samples_per_src=20000, los=True,
                 specular_reflection=True,
                 refraction=True,
                 diffraction=False,
                 diffuse_reflection=False,
                 diffuse_samples=4096,
                 max_num_wedges=20000,
                 seed=41, output="paths"):
        """``output="paths"`` (default) returns the full Paths object.
        ``output="gain"`` instead reduces each solver stage on the device
        to the incoherent per-link path gain
        sum_paths |a[rx, 0, tx, 0, p]|^2 and returns a [rx, tx] float32
        tensor: the radio-map hot path."""
        if output not in ("paths", "gain"):
            raise ValueError("output must be 'paths' or 'gain'")
        txs, rxs, rd, tri, normals, tx_pos, rx_pos = self._setup(scene)
        dev = self.device
        has_geometry = scene.num_triangles > 0

        # 1) Candidate reflection sequences via shoot-and-bounce
        sequences = [torch.zeros((1, 0), dtype=torch.int64, device=dev)] \
            if los else []
        if specular_reflection and has_geometry and max_depth > 0:
            sequences += self._candidates(tri, normals, tx_pos, max_depth,
                                          samples_per_src,
                                          max_num_paths_per_src)

        # 2) Image-method evaluation of every candidate
        eta_tri, scat_tri, th_tri = self._materials(scene, rd)
        dev_orient = np.stack([d.orientation for d in rxs])
        dev_vel = np.stack([d.velocity for d in rxs])
        rx_uniform = bool(np.all(dev_orient == dev_orient[:1])
                          and np.all(dev_vel == dev_vel[:1]))
        gain_mode = output == "gain"

        def reduce(out):
            return {"gain": _gain(out["a"])} if gain_mode else out

        results = []
        for seq in sequences:
            out = self._eval_sequences(
                scene, tri, normals, seq, tx_pos, rx_pos, eta_tri,
                scat_tri, txs, rxs, th_tri=th_tri, refraction=refraction,
                dense_links=gain_mode, output_gain=gain_mode,
                rx_uniform=rx_uniform)
            if not gain_mode:
                out["interactions"] = seq
            results.append(out)

        # 2b) First-order UTD wedge diffraction (wedges: host NumPy)
        if diffraction and has_geometry:
            wedges = extract_wedges(np.asarray(scene.triangles))
            num_w = wedges["origin"].shape[0]
            if num_w > max_num_wedges:
                # keep the wedges nearest the device centroid
                tx_np = np.stack([t.position for t in txs]).astype(rd)
                rx_np = np.stack([r.position for r in rxs]).astype(rd)
                mid = (tx_np.mean(axis=0) + rx_np.mean(axis=0)) / 2.
                mids = wedges["origin"] + 0.5 * wedges["length"][
                    :, None] * wedges["e_hat"]
                keep = np.argsort(
                    np.linalg.norm(mids - mid, axis=1))[:max_num_wedges]
                wedges = {k: v[keep] for k, v in wedges.items()}
                num_w = max_num_wedges
            if num_w > 0:
                wedges = {k: (v.astype(rd) if v.dtype.kind == "f" else v)
                          for k, v in wedges.items()}
                out = reduce(eval_diffraction(
                    scene, tri, wedges, tx_pos, rx_pos, eta_tri, txs, rxs,
                    th_tri=th_tri, refraction=refraction,
                    accel=self._accel))
                if not gain_mode:
                    out["interactions"] = torch.as_tensor(
                        wedges["tri_0"][:, None].astype(np.int64),
                        device=dev)
                    out["kind"] = 1
                results.append(out)

        # 2c) Diffuse (rough-surface) scattering, single bounce
        mats, idx = scene.material_table()
        scat_np = np.array([m.scattering_coefficient for m in mats],
                           rd)[idx]
        if diffuse_reflection and has_geometry and np.any(scat_np > 0.):
            sample = sample_scatter_points(scene, scat_np, diffuse_samples,
                                           seed, rd)
            if sample is not None:
                p_np, tri_idx, d_area = sample
                out = reduce(eval_scattering(
                    scene, tri, normals, tx_pos, rx_pos, eta_tri,
                    torch.as_tensor(p_np, device=dev), tri_idx, d_area,
                    diffuse_samples, seed, txs, rxs, th_tri=th_tri,
                    refraction=refraction, accel=self._accel))
                if not gain_mode:
                    out["interactions"] = torch.as_tensor(
                        tri_idx[:, None].astype(np.int64), device=dev)
                    out["kind"] = 2
                results.append(out)

        if gain_mode:
            # [rx, tx] incoherent path gain. The duplicate-path pass is
            # skipped: it only removes the measure-zero case of a
            # specular point landing exactly on an edge shared by two
            # coplanar triangles (counted once per triangle).
            gain = torch.zeros((len(rxs), len(txs)), dtype=torch.float32,
                               device=dev)
            for r in results:
                gain = gain + r["gain"]
            return gain

        def cat(field):
            return torch.cat([r[field] for r in results], dim=-1)

        # Pad interaction records to a common depth with -1
        inter = [r["interactions"] for r in results]
        width = max(max((i.shape[1] for i in inter), default=1), 1)
        inter = [torch.nn.functional.pad(i, (0, width - i.shape[1]),
                                         value=-1) for i in inter]
        # dedupe namespace: interaction kind (0 specular, 1 diffracted,
        # 2 scattered) * 1000 + bounce depth
        depths = np.concatenate(
            [np.full(r["interactions"].shape[0],
                     1000 * r.get("kind", 0) + r["interactions"].shape[1])
             for r in results])

        # per-path interaction type (upstream InteractionType codes:
        # 0 none/LoS, 1 specular, 2 diffracted, 3 scattered)
        def _type_code(r):
            kind = r.get("kind", 0)
            if kind == 1:
                return 2
            if kind == 2:
                return 3
            return 1 if r["interactions"].shape[1] > 0 else 0

        types = np.concatenate(
            [np.full(r["interactions"].shape[0], _type_code(r), np.int32)
             for r in results])
        paths = Paths(
            a=cat("a"), tau=cat("tau"), valid=cat("valid"),
            theta_t=cat("theta_t"), phi_t=cat("phi_t"),
            theta_r=cat("theta_r"), phi_r=cat("phi_r"),
            doppler=cat("doppler"),
            interactions=torch.cat(inter, dim=0),
            types=torch.as_tensor(types, device=dev))
        self._deduplicate(paths, torch.as_tensor(depths, device=dev))
        return paths

    def trace_functional(self, scene, max_depth=3,
                         samples_per_src=20000,
                         max_num_paths_per_src=100000, los=True,
                         refraction=False, seed=41):
        """Differentiable functional view of the LoS+specular solver.

        Candidate path discovery (shoot-and-bounce + prefix dedupe) runs
        once against the CURRENT scene geometry; the returned function
        re-evaluates the image-method refinement, occlusion, polarized
        Fresnel cascade and array responses for given device positions
        and per-triangle materials:

        ``fn(tx_pos [num_tx, 3], rx_pos [num_rx, 3],
        eta [num_tri] complex, scat [num_tri], thickness=None) ->
        (a [rx, rx_ant, tx, tx_ant, P] complex,
        tau [rx, tx, P], valid [rx, tx, P])``

        ``fn`` is differentiable with torch autograd with respect to
        every argument (transmitter/receiver placement, complex relative
        permittivity, scattering coefficient and, with ``refraction``,
        the thickness of blocking triangles). Geometry and the
        discovered candidate set are fixed: gradients hold for
        perturbations that do not change path topology (occlusion and
        validity masks are booleans with zero gradient). For a complex
        argument, torch's gradient is the conjugate of ``jax.grad``'s.

        Returns ``(fn, (tx_pos, rx_pos, eta, scat))`` with the arguments
        at their current scene values, tensors on the solver's device.
        """
        txs, rxs, rd, tri, normals, tx_pos, rx_pos = self._setup(scene)
        sequences = [torch.zeros((1, 0), dtype=torch.int64,
                                 device=self.device)] if los else []
        if scene.num_triangles > 0 and max_depth > 0:
            sequences += self._candidates(tri, normals, tx_pos, max_depth,
                                          samples_per_src,
                                          max_num_paths_per_src)
        eta0, scat0, th0 = self._materials(scene, rd)

        def fn(tx_pos, rx_pos, eta, scat, thickness=None):
            th = th0 if thickness is None else thickness
            outs = [self._eval_sequences(
                scene, tri, normals, seq, tx_pos, rx_pos, eta, scat, txs,
                rxs, th_tri=th, refraction=refraction)
                for seq in sequences]
            a = torch.cat([o["a"] for o in outs], dim=-1)
            tau = torch.cat([o["tau"] for o in outs], dim=-1)
            valid = torch.cat([o["valid"] for o in outs], dim=-1)
            return a, tau, valid

        return fn, (tx_pos, rx_pos, eta0, scat0)

    @staticmethod
    def _deduplicate(paths, depths):
        """Invalidates duplicate paths per (rx, tx) link, on the device.

        A specular point on an edge shared by two coplanar triangles
        yields the same physical path once per triangle; the first one
        is kept. Paths are keyed by (rx, tx, kind and depth, tau in ps,
        theta_t and phi_t in microradians); invalid paths take the key
        rx = -1 and are never kept."""
        valid = paths.valid
        num_rx, num_tx, num_p = valid.shape
        dev = valid.device
        shape = valid.shape
        i64 = torch.int64
        rx_key = torch.arange(num_rx, device=dev)[:, None, None] \
            .expand(shape)
        keys = torch.stack([
            torch.where(valid, rx_key, -1),
            torch.arange(num_tx, device=dev)[None, :, None].expand(shape),
            depths.to(i64)[None, None].expand(shape),
            torch.round(paths.tau * 1e12).to(i64),
            torch.round(paths.theta_t * 1e6).to(i64),
            torch.round(paths.phi_t * 1e6).to(i64),
        ], dim=-1).reshape(-1, 6)
        perm = lexsort_rows(keys)
        rows = keys[perm]
        first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           torch.any(rows[1:] != rows[:-1], dim=1)])
        keep = torch.zeros_like(first).index_put_((perm,), first)
        mask = valid & keep.reshape(shape)
        paths.valid = mask
        paths.a = paths.a * mask.to(paths.a.dtype)[:, None, :, None, :]
        paths.tau = torch.where(mask, paths.tau, -1.)

    # ------------------------------------------------------------------
    def _eval_sequences(self, scene, tri, normals, seq, tx_pos,
                        rx_pos, eta_tri, scat_tri, txs, rxs,
                        th_tri=None, refraction=False,
                        dense_links=False, output_gain=False,
                        rx_uniform=None):
        """Evaluates all [S] reflection sequences of equal depth D for
        all TX/RX pairs. Returns per-path fields with S paths.

        With ``refraction=True`` blocked segments are not discarded:
        each blocking triangle applies its ITU-R P.2040 slab
        transmission coefficients (see
        :func:`em.transmission_jones_product`)."""
        num_tx = tx_pos.shape[0]
        num_rx = rx_pos.shape[0]
        s_count, depth = seq.shape

        # --- Mirror cascade: images of each TX across the sequence
        # planes. images[k]: [S, num_tx, 3]
        if depth > 0:
            v0 = tri[seq, 0]                           # [S, D, 3]
            n_pl = normals[seq]                        # [S, D, 3]
        images = [tx_pos[None].expand(s_count, num_tx, 3)]
        for k in range(depth):
            q = images[-1]
            d = torch.sum((q - v0[:, None, k]) * n_pl[:, None, k],
                          dim=-1, keepdim=True)
            images.append(q - 2. * d * n_pl[:, None, k])

        # --- Backward construction of reflection points
        # x[k]: [S, num_tx, num_rx, 3]; x[depth+1] = rx
        x_next = rx_pos[None, None].expand(s_count, num_tx, num_rx, 3)
        points = [x_next]
        valid = torch.ones((s_count, num_tx, num_rx), dtype=torch.bool,
                           device=tri.device)
        for k in range(depth, 0, -1):
            q_k = images[k][:, :, None]                # [S,tx,1,3]
            v0_k = v0[:, None, None, k - 1]
            n_k = n_pl[:, None, None, k - 1]
            seg = x_next - q_k
            denom = torch.sum(seg * n_k, dim=-1)
            num = torch.sum((v0_k - q_k) * n_k, dim=-1)
            ok = torch.abs(denom) > 1e-12
            t_par = torch.where(ok, num / torch.where(ok, denom, 1.), -1.)
            valid = valid & (t_par > 1e-9) & (t_par < 1. + 1e-9)
            x_k = q_k + t_par[..., None] * seg
            # x_k must lie inside triangle k-1 (barycentric test)
            corners = tri[seq[:, k - 1]][:, None, None]   # [S,1,1,3,3]
            valid = valid & in_triangle(x_k, corners[..., 0, :],
                                        corners[..., 1, :],
                                        corners[..., 2, :])
            points.append(x_k)
            x_next = x_k
        points.append(tx_pos[None, :, None].expand(s_count, num_tx,
                                                   num_rx, 3))
        # points list is [rx, x_D, ..., x_1, tx] -> reverse
        pts = torch.stack(points[::-1], dim=0)  # [D+2, S, tx, rx, 3]

        # --- Segment directions and lengths
        segs = pts[1:] - pts[:-1]               # [D+1, S, tx, rx, 3]
        seg_len = torch.linalg.norm(segs, dim=-1)
        d_hat = segs / torch.clamp(seg_len[..., None], min=1e-30)
        total_len = torch.sum(seg_len, dim=0)   # [S, tx, rx]
        valid = valid & (total_len > 1e-6)
        n_pl_arg = n_pl if depth > 0 else None

        big_r = s_count * num_tx * num_rx
        # Gain output with valid-pair compaction: for radio maps (every
        # cell a receiver) only the geometrically valid (sequence, cell)
        # pairs, typically 10-30%, need the EM field math above the gain
        # reduction. They are gathered (one host sync for their count),
        # the tail runs on [count, 1, 1], and per-cell gains are
        # scatter-added. Gated on a single TX and uniform RX devices so
        # the combine stage can use one representative device.
        if rx_uniform is None:
            rx_uniform = _uniform_devices(rxs)
        if (output_gain and num_tx == 1
                and big_r > GAIN_COMPACT_MIN_PAIRS and rx_uniform):
            sel = torch.nonzero(valid.reshape(-1))[:, 0]
            gain = torch.zeros((num_rx, num_tx), dtype=torch.float32,
                               device=tri.device)
            if sel.numel() == 0:
                return {"gain": gain}
            r_id = sel % num_rx
            s_id = sel // (num_rx * num_tx)

            def pick(x):
                return x.reshape(x.shape[0], big_r, 3)[:, sel][
                    :, :, None, None, :]

            out = self._eval_tail(
                scene, tri, seq[s_id],
                n_pl[s_id] if depth > 0 else None, pick(pts),
                pick(segs), pick(d_hat),
                total_len.reshape(big_r)[sel][:, None, None],
                torch.ones((sel.shape[0], 1, 1), dtype=torch.bool,
                           device=tri.device),
                eta_tri, scat_tri, th_tri, refraction, [txs[0]], [rxs[0]],
                compact_transmission=False)
            g = torch.abs(out["a"][0, 0, 0, 0, :]) ** 2
            return {"gain": gain.index_add_(0, r_id, g[:, None])}

        out = self._eval_tail(scene, tri, seq, n_pl_arg, pts, segs,
                              d_hat, total_len, valid, eta_tri,
                              scat_tri, th_tri, refraction, txs, rxs,
                              dense_links=dense_links)
        if output_gain:
            return {"gain": _gain(out["a"])}
        return out

    # ------------------------------------------------------------------
    def _eval_tail(self, scene, tri, seq, n_pl, pts, segs, d_hat,
                   total_len, valid, eta_tri, scat_tri, th_tri,
                   refraction, txs, rxs, dense_links=False,
                   compact_transmission=True):
        """EM field transfer for geometrically valid specular paths:
        per-segment transverse bases, Fresnel reflection matrices,
        through-blocker transmission, the Jones cascade, and the
        antenna/Doppler combine. Shapes carry a generic [S, num_tx,
        num_rx] leading layout; the gain path calls this on compacted
        valid pairs reshaped to [count, 1, 1]."""
        lam = scene.wavelength
        s_count = pts.shape[1]
        num_tx = pts.shape[2]
        num_rx = pts.shape[3]
        depth = pts.shape[0] - 2
        c64 = torch.complex64
        # --- Per-segment transverse bases and reflection matrices.
        # seg_basis[k] = (e_a, e_b) frame the field is expressed in
        # while traveling segment k; each reflection rotates into the
        # next frame. Bases are needed BEFORE the occlusion stage so
        # through-blocker transmission can be applied as a full
        # polarimetric 2x2 Jones factor in the segment's own frame.
        e_a, e_b = sph_basis(d_hat[0])        # [S,tx,rx,3] each
        seg_basis = [(e_a, e_b)]
        refl_rot = []
        for k in range(depth):
            d_in = d_hat[k]
            d_out = d_hat[k + 1]
            n_k = n_pl[:, None, None, k]
            n_k = torch.where(
                torch.sum(n_k * d_in, dim=-1, keepdim=True) > 0,
                -n_k, n_k)
            cos_i = torch.clamp(-torch.sum(d_in * n_k, dim=-1),
                                0., 1.).to(torch.float32)
            # s (TE) axis; fall back to e_a at normal incidence
            e_s = torch.linalg.cross(d_in, n_k)
            s_norm = torch.linalg.norm(e_s, dim=-1, keepdim=True)
            e_s = torch.where(s_norm > 1e-6,
                              e_s / torch.clamp(s_norm, min=1e-30), e_a)
            e_p_in = torch.linalg.cross(e_s, d_in)
            e_p_out = torch.linalg.cross(e_s, d_out)
            # Fresnel coefficients (shared algebra in em.py)
            eta = eta_tri[seq[:, k]][:, None, None]
            r_s, r_p = fresnel_coefficients(cos_i, eta)
            s_coef = torch.sqrt(torch.clamp(
                1. - scat_tri[seq[:, k]][:, None, None] ** 2, min=0.)
            ).to(torch.float32)
            r_s = r_s * s_coef
            r_p = r_p * s_coef
            # Basis rotation into (e_s, e_p_in)
            rot = torch.stack(
                [torch.stack([torch.sum(e_s * e_a, -1),
                              torch.sum(e_s * e_b, -1)], -1),
                 torch.stack([torch.sum(e_p_in * e_a, -1),
                              torch.sum(e_p_in * e_b, -1)], -1)],
                dim=-2).to(c64)
            refl = torch.diag_embed(torch.stack([r_s.to(c64),
                                                 r_p.to(c64)], dim=-1))
            refl_rot.append((refl, rot))
            e_a, e_b = e_s, e_p_out
            seg_basis.append((e_a, e_b))

        # --- Occlusion: without refraction every segment must be free
        # of intersections (ignoring the reflecting triangles at its
        # endpoints); with refraction each blocker instead applies its
        # per-polarization TE/TM slab coefficients as a 2x2 Jones factor
        # in the segment's frame (em.transmission_jones_product)
        jones_t = [None] * (depth + 1)
        if scene.num_triangles > 0:
            big_r = s_count * num_tx * num_rx
            accel = self._accel
            shape = (s_count, num_tx, num_rx)

            def seg_inputs(k):
                o = pts[k].reshape(-1, 3)
                d = segs[k].reshape(-1, 3)
                excl_ids = None
                if depth > 0:
                    none = torch.full((s_count,), -1, dtype=seq.dtype,
                                      device=seq.device)
                    excl = torch.stack(
                        [seq[:, kk] if 0 <= kk < depth else none
                         for kk in (k - 1, k)], dim=1)      # [S, 2]
                    excl_ids = excl[:, None, None, :].expand(
                        *shape, 2).reshape(-1, 2)
                return o, d, excl_ids

            if refraction:
                def jones_all(sel=None):
                    """Per-segment transmission Jones factors,
                    optionally on a compacted ray subset."""
                    outs = []
                    for k in range(depth + 1):
                        o, d, excl_ids = seg_inputs(k)
                        ea_k, eb_k = seg_basis[k]
                        ea_k = ea_k.expand(*shape, 3).reshape(-1, 3)
                        eb_k = eb_k.expand(*shape, 3).reshape(-1, 3)
                        if sel is not None:
                            o, d, ea_k, eb_k = (o[sel], d[sel],
                                                ea_k[sel], eb_k[sel])
                            if excl_ids is not None:
                                excl_ids = excl_ids[sel]
                        if accel is not None:
                            jt = transmission_jones_product_accel(
                                o, d, accel, eta_tri, th_tri, lam,
                                ea_k, eb_k, excl_ids=excl_ids)
                        else:
                            jt = transmission_jones_product(
                                o, d, tri, eta_tri, th_tri, lam,
                                ea_k, eb_k, excl_ids=excl_ids)
                        outs.append(jt)
                    return outs

                # Valid-pair compaction: only geometrically valid
                # (sequence, tx, rx) pairs need the through-blocker
                # transmission query, typically a small fraction of the
                # candidate set. Invalid rays keep an identity factor,
                # which is irrelevant: combine_paths zeroes their
                # field. Dense-link workloads (radio maps: every cell a
                # receiver) keep ~10-20% of pairs valid; sparse-link
                # path solves well under 1%; below the size where the
                # gather pays, the query runs on every pair.
                frac = 4 if dense_links else 64
                floor = 4096 if dense_links else 1024
                cap = min(big_r, big_r // frac + floor)
                if compact_transmission and cap < big_r:
                    sel = torch.nonzero(valid.reshape(-1))[:, 0]
                    eye = torch.eye(2, dtype=c64, device=pts.device) \
                        .expand(big_r, 2, 2)
                    jt_list = [eye.index_put((sel,), jt)
                               for jt in jones_all(sel)]
                else:
                    jt_list = jones_all(None)
                jones_t = [jt.reshape(*shape, 2, 2) for jt in jt_list]
            else:
                for k in range(depth + 1):
                    o, d, excl_ids = seg_inputs(k)
                    blocked = any_blocking_hit(
                        o, d, tri, excl_ids=excl_ids, accel=accel)
                    valid = valid & ~blocked.reshape(shape)

        # --- Polarized field transfer (Jones matrix cascade):
        # segment-k transmission (in frame k), then reflection k
        jones = torch.eye(2, dtype=c64, device=pts.device).expand(
            s_count, num_tx, num_rx, 2, 2)
        for k in range(depth + 1):
            if jones_t[k] is not None:
                jones = jones_t[k] @ jones
            if k < depth:
                refl, rot = refl_rot[k]
                jones = refl @ rot @ jones
        e_a, e_b = seg_basis[-1]

        # Project onto the receive spherical basis (arrival direction
        # u_r = -d_hat[-1]; e_theta(-u)=e_theta(u), e_phi(-u)=-e_phi(u))
        u_r = -d_hat[-1]
        e_tr, e_pr = sph_basis(u_r)
        proj = torch.stack(
            [torch.stack([torch.sum(e_tr * e_a, -1),
                          torch.sum(e_tr * e_b, -1)], -1),
             torch.stack([torch.sum(e_pr * e_a, -1),
                          torch.sum(e_pr * e_b, -1)], -1)],
            dim=-2).to(c64)
        jones = proj @ jones                    # [S,tx,rx,2,2]

        mag = (lam / (4. * PI * torch.clamp(total_len, min=1e-9))
               ).to(torch.float32)
        # through-blocker transmission is folded into the Jones cascade
        # (jones_t factors); amp carries spreading + phase
        amp = mag * phase_exp(total_len, lam)
        tau = total_len / SPEED_OF_LIGHT
        return combine_paths(scene, txs, rxs, d_hat[0], u_r, jones,
                             amp, valid, tau)
