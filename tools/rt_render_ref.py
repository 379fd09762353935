"""Reference numbers of ``chip_smoke.py`` phase 32 (the renderer) by the
JAX package on the CPU: the values phase 32 holds the PyTorch port's
images on the card to (``RT_RENDER_JAX``).

Phase 32's views (``chip_smoke.RT_RENDER``: 655 x 500, the default fov,
each scene with its phase's tx and rx as markers) rendered by the JAX
package's ``Scene.render``:

- ``canyon``: phase 29's canyon;
- ``map``: the same view under phase 31's radio map (200 x 200 cells of
  1 m, depth 2, 100,000 rays), as the overlay;
- ``city_cut``: phase 30's cut city (``make_city(3, 3, subdiv=4)``).

For each: the per-channel mean, the counts of sky, geometry, tx-marker,
rx-marker and overlay pixels (``chip_smoke.render_stats``), and every
997th pixel with the triangle its ray hits (-1 for none; JAX's
``nearest_hit`` on the same rays), so that a pixel shaded from another
triangle on a shared edge can be told apart (the ``map`` view's rays
hit the canyon's triangles). For the ``map`` view also the map cell
under each sampled pixel (row-major, -1 off the map; the renderer's own
plane lookup) and JAX's path gain there, so that a pixel over a cell
where the card's map differs from JAX's can be told apart.
The full city (100,200 triangles) is held on the card to the port's own
dense sweep instead.

Prints one JSON object, from the repository root (under a minute)::

    PYTHONPATH=. python tools/rt_render_ref.py
"""

import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sionna_tpu.rt as rt  # noqa: E402
from sionna_tpu.rt.solver import _rot_matrix, nearest_hit  # noqa: E402

from chip_smoke import (RT_RENDER, render_map, render_scene,  # noqa: E402
                        render_stats)


def sampled_rays(camera, resolution, stride, fov=45.):
    """The JAX renderer's pinhole rays (``sionna_tpu/rt/render.py``) of
    every ``stride``-th pixel: (origins, directions) [N, 3] float64."""
    w, h = resolution
    rot = _rot_matrix(np.asarray(camera.orientation, np.float64))
    tan = np.tan(np.deg2rad(fov) / 2.)
    yg, zg = np.meshgrid(np.linspace(tan, -tan, w),
                         np.linspace(tan * h / w, -tan * h / w, h))
    d = np.stack([np.ones_like(yg), yg, zg], axis=-1) @ rot.T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.reshape(-1, 3)[::stride]
    return np.broadcast_to(np.asarray(camera.position, np.float64),
                           d.shape), d


def sampled_cells(orig, dirs, rm):
    """Row-major cell of ``rm`` under each ray's hit of the map's plane
    (-1 off the map), by the JAX renderer's overlay lookup in float64."""
    cells = np.asarray(rm.cell_centers)
    ny, nx = cells.shape[:2]
    x0, y0, z0 = cells[0, 0]
    dx = (cells[0, -1, 0] - x0) / max(nx - 1, 1)
    dy = (cells[-1, 0, 1] - y0) / max(ny - 1, 1)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore"):
        t_pl = np.where(np.abs(dz) > 1e-9, (z0 - orig[:, 2]) / dz, np.inf)
    p = orig + t_pl[:, None] * dirs
    ix = np.round((p[:, 0] - x0) / max(abs(dx), 1e-9)).astype(np.int64)
    iy = np.round((p[:, 1] - y0) / max(abs(dy), 1e-9)).astype(np.int64)
    ix, iy = (-ix if dx < 0 else ix), (-iy if dy < 0 else iy)
    inside = (t_pl > 0) & (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    return np.where(inside, iy * nx + ix, -1)


def main():
    res = RT_RENDER["resolution"]
    out = {}
    for view in ("canyon", "city_cut"):
        scene = render_scene(rt, view)
        img = np.asarray(scene.render(resolution=res))
        stats = render_stats(img)
        orig, dirs = sampled_rays(scene.cameras["cam"], res,
                                  RT_RENDER["sample_stride"])
        _, idx, hit = nearest_hit(jnp.asarray(orig), jnp.asarray(dirs),
                                  jnp.asarray(scene.triangles))
        stats["sample"] = [[float(f"{v:.7g}") for v in px]
                           for px in stats["sample"]]
        stats["sample_tri"] = np.where(np.asarray(hit), np.asarray(idx),
                                       -1).tolist()
        out[view] = stats
        if view == "canyon":
            rm = render_map(rt, scene)
            stats = render_stats(np.asarray(scene.render(
                resolution=res, radio_map=rm)), img)
            stats["sample"] = [[float(f"{v:.7g}") for v in px]
                               for px in stats["sample"]]
            cell = sampled_cells(orig, dirs, rm)
            gain = np.asarray(rm.path_gain)[0].reshape(-1)
            stats["sample_cell"] = cell.tolist()
            stats["sample_cell_gain"] = [
                float(f"{gain[c]:.9g}") if c >= 0 else 0. for c in cell]
            out["map"] = stats
    print(json.dumps(out))


if __name__ == "__main__":
    main()
