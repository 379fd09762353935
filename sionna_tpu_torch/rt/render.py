"""Scene rendering (API parity with sionna.rt's Camera/render surface).

PyTorch counterpart of ``sionna_tpu/rt/render.py``: a minimal ray-cast
renderer on the path solver's intersection code (``geometry.nearest_hit``,
through the clustered acceleration structure for scenes of
``ACCEL_MIN_TRIS`` or more triangles): pinhole camera rays, Lambertian
shading from a fixed sky light, a per-material albedo, device markers and
a radio-map overlay. The camera rays, the albedos and the overlay's
colours are made on the host in float64, as the JAX package makes them;
the rays are traced and shaded on ``config.device`` (the card unless the
caller sets the CPU) in its geometry dtype, and the image comes back as
NumPy.
"""

import hashlib

import numpy as np
import torch

from .accel import build_accel
from .geometry import (nearest_hit, real_dtype, resolve_device, rot_matrix,
                       tri_normals)
from .solver import ACCEL_MIN_TRIS

__all__ = ["render"]

_SKY = np.array([0.72, 0.82, 0.92])
TX_COLOR = (0.85, 0.15, 0.1)
RX_COLOR = (0.1, 0.7, 0.2)


def _material_albedo(name):
    """Deterministic pleasant albedo per material name."""
    h = int(hashlib.blake2b(name.encode(),
                            digest_size=4).hexdigest(), 16)
    rng = np.random.default_rng(h)
    base = 0.35 + 0.5 * rng.random(3)
    if "metal" in name:
        base = np.array([0.62, 0.64, 0.70])
    elif "concrete" in name:
        base = np.array([0.62, 0.60, 0.57])
    elif "ground" in name or "wood" in name:
        base = np.array([0.45, 0.38, 0.30])
    elif "glass" in name:
        base = np.array([0.55, 0.68, 0.75])
    return base


def camera_rays(camera, resolution, fov):
    """Pinhole rays of ``camera`` (+x forward, y left, z up in its
    frame): host float64 (origins, unit directions), each [h * w, 3] in
    row-major pixel order."""
    w, h = int(resolution[0]), int(resolution[1])
    rot = rot_matrix(camera.orientation)
    tan = np.tan(np.deg2rad(fov) / 2.)
    ys = np.linspace(tan, -tan, w)                  # image x -> -y
    zs = np.linspace(tan * h / w, -tan * h / w, h)  # image y -> -z
    yg, zg = np.meshgrid(ys, zs)                    # [h, w]
    d_cam = np.stack([np.ones_like(yg), yg, zg], axis=-1)
    d_world = d_cam @ rot.T
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
    orig = np.tile(np.asarray(camera.position, np.float64), (h * w, 1))
    return orig, d_world.reshape(-1, 3)


def _overlay_image(radio_map, rm_metric, rm_vmin, rm_vmax, rm_tx):
    """The radio map's metric as colours [ny, nx, 3] on a 3-stop ramp
    (dark blue -> teal -> yellow) between ``rm_vmin`` and ``rm_vmax``
    dB, host NumPy, and its cell centres [ny, nx, 3]."""
    if rm_metric == "path_gain":
        val = radio_map.path_gain[rm_tx]
    elif rm_metric == "rss":
        val = radio_map.rss[rm_tx]
    elif rm_metric == "sinr":
        val = radio_map.sinr
    else:
        raise ValueError(f"Unknown rm_metric {rm_metric!r}")
    val = val.cpu().numpy()
    db = 10. * np.log10(np.maximum(val, 1e-30))
    lo_db = (np.percentile(db[np.isfinite(db)], 5.)
             if rm_vmin is None else float(rm_vmin))
    hi_db = (db.max() if rm_vmax is None else float(rm_vmax))
    t = np.clip((db - lo_db) / max(hi_db - lo_db, 1e-9), 0., 1.)
    stops = np.array([[0.27, 0.0, 0.33], [0.13, 0.57, 0.55],
                      [0.99, 0.91, 0.14]])
    seg = np.clip(t * 2., 0., 2.)
    c0 = stops[np.minimum(seg.astype(int), 1)]
    c1 = stops[np.minimum(seg.astype(int) + 1, 2)]
    frac = (seg - np.floor(np.minimum(seg, 1.9999)))[..., None]
    rm_img = c0 + frac * (c1 - c0)
    rm_img = np.where((db <= lo_db)[..., None], _SKY * 0. + 0.15, rm_img)
    return rm_img, np.asarray(radio_map.cell_centers)


def render(scene, camera=None, resolution=(320, 240), fov=45.,
           light_dir=(0.35, -0.25, 0.9), radio_map=None,
           rm_metric="path_gain", rm_vmin=None, rm_vmax=None,
           rm_tx=0, clip_at=None):
    """Renders the scene from ``camera`` (or the first registered
    camera) to an RGB image, a NumPy [h, w, 3] float32 array in [0, 1].

    Transmitters render as red markers, receivers as green ones
    (billboard spheres of ~1% of the scene diagonal). ``radio_map``
    overlays a RadioMap's metric (dB colormap between ``rm_vmin`` /
    ``rm_vmax``) on its measurement plane; ``clip_at`` removes all
    triangles whose centroid is above that height [m] (upstream
    Scene.render semantics for looking into street canyons). The rays
    are traced on ``config.device``."""
    if camera is None:
        if not scene.cameras:
            raise ValueError("The scene has no camera; add one or "
                             "pass camera=")
        camera = next(iter(scene.cameras.values()))
    w, h = int(resolution[0]), int(resolution[1])
    dev = resolve_device()
    rd = real_dtype(dev)
    orig, dirs = camera_rays(camera, resolution, fov)

    tri_np = np.asarray(scene.triangles)
    if tri_np.shape[0]:
        materials, index = scene.material_table()
        albedo = np.stack([_material_albedo(m.name)
                           for m in materials])[index]
    else:
        albedo = np.zeros((1, 3))
    if clip_at is not None and tri_np.shape[0]:
        keep = tri_np.mean(axis=1)[:, 2] <= float(clip_at)
        tri_np = tri_np[keep]
        albedo = albedo[keep]
    has_geometry = tri_np.shape[0] > 0

    overlay = None
    if radio_map is not None:
        overlay = _overlay_image(radio_map, rm_metric, rm_vmin, rm_vmax,
                                 rm_tx)

    # device markers as billboard spheres
    if has_geometry:
        lo = tri_np.reshape(-1, 3).min(0)
        hi = tri_np.reshape(-1, 3).max(0)
        marker_r = max(float(np.linalg.norm(hi - lo)) * 0.008, 0.25)
    else:
        marker_r = 0.5
    markers = [(t.position, TX_COLOR) for t in scene.transmitters.values()]
    markers += [(r.position, RX_COLOR) for r in scene.receivers.values()]

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=rd,
                               device=dev)

    o, d = put(orig), put(dirs)
    if has_geometry:
        host_tri = tri_np.astype(np.float64 if rd == torch.float64
                                 else np.float32)
        tri = torch.as_tensor(host_tri, device=dev)
        accel = (build_accel(host_tri, dev)
                 if tri_np.shape[0] >= ACCEL_MIN_TRIS else None)
        t_min, idx, hit = nearest_hit(o, d, tri, accel=accel)
        light = np.asarray(light_dir, np.float64)
        lam = torch.abs(torch.sum(
            tri_normals(tri)[idx] * put(light / np.linalg.norm(light)), -1))
        shade = (0.35 + 0.65 * lam)[:, None] * put(albedo)[idx]
    else:
        t_min = torch.full((o.shape[0],), torch.inf, dtype=rd, device=dev)
        hit = torch.zeros((o.shape[0],), dtype=torch.bool, device=dev)
        shade = torch.zeros((o.shape[0], 3), dtype=rd, device=dev)
    img = torch.where(hit[:, None], shade, put(_SKY))
    depth = torch.where(hit, t_min, torch.inf)
    # ray-sphere tests for device markers
    for p, c in markers:
        oc = o - put(p)
        b = torch.sum(oc * d, -1)
        disc = b ** 2 - (torch.sum(oc * oc, -1) - marker_r ** 2)
        t_hit = -b - torch.sqrt(torch.clamp(disc, min=0.))
        m_hit = (disc > 0.) & (t_hit > 0.) & (t_hit < depth)
        img = torch.where(m_hit[:, None], put(c), img)
        depth = torch.where(m_hit, t_hit, depth)
    if overlay is not None:
        # semi-transparent overlay on the measurement plane
        rm_img, rm_cells = overlay
        ny, nx = rm_img.shape[:2]
        z0 = float(rm_cells[0, 0, 2])
        x0 = float(rm_cells[0, 0, 0])
        y0 = float(rm_cells[0, 0, 1])
        dx = (float(rm_cells[0, -1, 0]) - x0) / max(nx - 1, 1)
        dy = (float(rm_cells[-1, 0, 1]) - y0) / max(ny - 1, 1)
        dz = d[:, 2]
        t_pl = torch.where(torch.abs(dz) > 1e-9, (z0 - o[:, 2]) / dz,
                           torch.inf)
        p = o + t_pl[:, None] * d
        ix = torch.round((p[:, 0] - x0) / max(abs(dx), 1e-9)).to(
            torch.int64)
        iy = torch.round((p[:, 1] - y0) / max(abs(dy), 1e-9)).to(
            torch.int64)
        if dx < 0:
            ix = -ix
        if dy < 0:
            iy = -iy
        inside = ((t_pl > 0.) & (ix >= 0) & (ix < nx) & (iy >= 0)
                  & (iy < ny) & (t_pl < depth + 1e-6))
        col = put(rm_img)[torch.clamp(iy, 0, ny - 1),
                          torch.clamp(ix, 0, nx - 1)]
        img = torch.where(inside[:, None], 0.35 * img + 0.65 * col, img)
    return img.to(torch.float32).cpu().numpy().reshape(h, w, 3)
