"""Reference numbers of BASELINE config 4 (the ray tracer) by the JAX
package on the CPU: the values ``chip_smoke.py`` phases 29 and 31 hold
the PyTorch port on the card to (``RT_JAX``).

- ``canyon``: bench.py's canyon path solve (``simple_street_canyon`` at
  3.5 GHz, iso V arrays, tx at [-20, 0, 10], rx at [20, 5, 1.5],
  ``max_depth=3``, ``samples_per_src=200_000``): the valid paths per
  interaction depth and the total path gain sum |a|^2.
- ``map``: bench.py's radio map (the same scene and tx, 200 x 200 cells
  of 1 m at height 1.5, ``max_depth=2``, ``samples_per_src=100_000``):
  the cells above 1e-15, the mean and standard deviation of their gain
  in dB, the largest gain, and a fixed sample of the cells' gains
  (every ``SAMPLE_STRIDE``-th cell of the flattened [y, x] map) with the
  positions in that sample of the cells that a corner path reaches (see
  ``corner_receivers``; the sample's receivers are solved in paths mode
  for that).
- ``city``: a cut of bench.py's city (``make_city(3, 3, subdiv=4)``,
  1,472 triangles, tx 30 m above one street intersection and rx at 1.5 m
  on the next, [-16, -16, 30] and [-16, 16, 1.5], as bench.py's city
  places them, depth 2, 20,000 samples, the accelerated path forced with
  ``ACCEL_MIN_TRIS=0``): the valid paths per depth and the total gain.
  The full city (``make_city(10, 10, subdiv=10)``, 100,200 triangles)
  is held on the card to the port's own dense sweep instead.

Prints one JSON line per part, from the repository root::

    PYTHONPATH=. python tools/rt_ref.py --part canyon
    PYTHONPATH=. python tools/rt_ref.py --part map
    PYTHONPATH=. python tools/rt_ref.py --part city
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import sionna_tpu.rt as rt  # noqa: E402
import sionna_tpu.rt.solver as solver_mod  # noqa: E402

TX = [-20., 0., 10.]
RX = [20., 5., 1.5]
CITY_TX = [-16., -16., 30.]
CITY_RX = [-16., 16., 1.5]
SAMPLE_STRIDE = 97


def canyon(frequency=3.5e9):
    """bench.py's canyon scene with its tx and rx."""
    scene = rt.load_scene("simple_street_canyon", frequency=frequency)
    scene.tx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.rx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.add(rt.Transmitter("tx", TX))
    scene.add(rt.Receiver("rx", RX))
    return scene


def path_stats(paths):
    """Valid paths per number of interactions and the total gain."""
    valid = np.asarray(paths.valid)[0, 0]
    depth = np.sum(np.asarray(paths.interactions) >= 0, axis=1)
    per_depth = [int(np.sum(valid & (depth == d)))
                 for d in range(int(depth.max()) + 1)]
    gain = float(np.sum(np.abs(np.asarray(paths.a)[0, 0, 0, 0]) ** 2))
    return per_depth, gain


def part_canyon():
    paths = rt.PathSolver()(canyon(), max_depth=3,
                            samples_per_src=200_000)
    per_depth, gain = path_stats(paths)
    return {"valid_per_depth": per_depth, "gain": gain}


def corner_receivers(scene, paths):
    """[rx] mask of the receivers with a valid specular path that has a
    segment shorter than 1e-9 m: a reflection at the line where two
    reflecting planes meet (a ground-wall corner), where two consecutive
    reflection points coincide. The zero-length segment has no
    direction, so such a path's field depends on how a package rounds
    (ROADMAP.md "Not faults"). NumPy, from the paths' triangles."""
    tri = scene.triangles
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    txs = [t.position for t in scene.transmitters.values()]
    rxs = [r.position for r in scene.receivers.values()]
    inter = np.asarray(paths.interactions)
    valid = np.asarray(paths.valid)
    types = np.asarray(paths.types)
    out = np.zeros(valid.shape[0], bool)
    for r, t, p in zip(*np.nonzero(valid)):
        if types[p] != 1:
            continue
        ids = [i for i in inter[p] if i >= 0]
        images = [txs[t]]
        for i in ids:
            q = images[-1]
            images.append(q - 2. * np.dot(q - tri[i, 0], normals[i])
                          * normals[i])
        pts = [rxs[r]]
        for k in range(len(ids), 0, -1):
            i = ids[k - 1]
            seg = pts[-1] - images[k]
            t_par = np.dot(tri[i, 0] - images[k], normals[i]) \
                / np.dot(seg, normals[i])
            pts.append(images[k] + t_par * seg)
        pts.append(txs[t])
        seg_len = np.linalg.norm(np.diff(np.array(pts), axis=0), axis=1)
        out[r] |= seg_len.min() < 1e-9
    return out


def part_map():
    size, height, depth, samples = (200, 200), 1.5, 2, 100_000
    rm = rt.RadioMapSolver()(canyon(), cell_size=(1., 1.), size=size,
                             center=(0., 0., height), max_depth=depth,
                             samples_per_src=samples)
    pg = np.asarray(rm.path_gain)[0]
    live = pg > 1e-15
    db = 10. * np.log10(pg[live])
    # the sampled cells as receivers of one paths-mode solve
    cells = np.stack(np.meshgrid(
        np.arange(size[0]) - (size[0] - 1) / 2,
        np.arange(size[1]) - (size[1] - 1) / 2), -1).reshape(-1, 2)
    idx = np.arange(0, pg.size, SAMPLE_STRIDE)
    scene = canyon()
    scene.receivers.clear()
    for i in idx:
        scene.add(rt.Receiver(f"cell_{i}", [*cells[i], height]))
    paths = rt.PathSolver()(scene, max_depth=depth,
                            samples_per_src=samples)
    corner = corner_receivers(scene, paths)
    return {"cells": int(pg.size), "live": int(live.sum()),
            "mean_db": float(db.mean()), "std_db": float(db.std()),
            "max": float(pg.max()), "sample_stride": SAMPLE_STRIDE,
            "sample": [float(g) for g in pg.reshape(-1)[idx]],
            "sample_corner": [int(k) for k in np.nonzero(corner)[0]]}


def part_city():
    city = rt.make_city(3, 3, subdiv=4)
    city.tx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    city.rx_array = rt.PlanarArray(1, 1, pattern="iso", polarization="V")
    city.add(rt.Transmitter("tx", CITY_TX))
    city.add(rt.Receiver("rx", CITY_RX))
    solver_mod.ACCEL_MIN_TRIS = 0
    paths = rt.PathSolver()(city, max_depth=2, samples_per_src=20_000)
    per_depth, gain = path_stats(paths)
    return {"triangles": city.num_triangles, "valid_per_depth": per_depth,
            "gain": gain}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--part", choices=["canyon", "map", "city"],
                        required=True)
    args = parser.parse_args()
    t0 = time.perf_counter()
    out = {"canyon": part_canyon, "map": part_map,
           "city": part_city}[args.part]()
    out["part"] = args.part
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
