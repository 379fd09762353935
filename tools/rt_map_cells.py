"""Holds bench.py's radio map (``chip_smoke.py`` phase 31's: the street
canyon, 200 x 200 cells of 1 m at height 1.5, depth 2, 100,000 rays) by
the PyTorch port cell by cell: against the JAX package's sample of cells
(``chip_smoke.RT_JAX["map"]``, from ``tools/rt_ref.py --part map``) and
against the port's own map on the CPU in float64 geometry; then prints
the valid paths of the three cells that differ most, solved on both devices.

    PYTHONPATH=. python tools/rt_map_cells.py                # the card
    PYTHONPATH=. python tools/rt_map_cells.py --device cpu --float32

``--float32`` solves the map under test in float32 geometry (the card's
dtype) also on the CPU, which reproduces the card's rounding there.
"""

import argparse

import numpy as np
import torch

import chip_smoke as cs
import sionna_tpu_torch.rt as rt
import sionna_tpu_torch.rt.solver as solver_mod

C = cs.RT_MAP
KW = dict(cell_size=C["cell_size"], size=C["size"], center=C["center"],
          max_depth=C["max_depth"], samples_per_src=C["samples"])


def scene(rx=None):
    return cs.rt_scene(rt, "simple_street_canyon", cs.RT_CANYON["tx"],
                       cs.RT_CANYON["rx"] if rx is None else rx)


def solve_map(device, dtype=None):
    """[y, x] path gains of the map, float64 on the host."""
    real_dtype = solver_mod.real_dtype
    if dtype is not None:
        solver_mod.real_dtype = lambda dev: dtype
    try:
        return rt.RadioMapSolver(device=device)(scene(), **KW) \
            .path_gain[0].double().cpu().numpy()
    finally:
        solver_mod.real_dtype = real_dtype


def path_list(device, rx, dtype=None):
    """The valid paths' interactions and |a|^2 of one receiver."""
    real_dtype = solver_mod.real_dtype
    if dtype is not None:
        solver_mod.real_dtype = lambda dev: dtype
    try:
        p = rt.PathSolver(device=device)(scene(rx),
                                         max_depth=C["max_depth"],
                                         samples_per_src=C["samples"])
    finally:
        solver_mod.real_dtype = real_dtype
    valid = p.valid[0, 0].cpu().numpy()
    inter = p.interactions.cpu().numpy()
    a2 = (p.a[0, 0, 0, 0].abs() ** 2).double().cpu().numpy()
    return {tuple(int(i) for i in inter[k]): float(a2[k])
            for k in range(valid.size) if valid[k]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--float32", action="store_true")
    args = parser.parse_args()
    dtype = torch.float32 if args.float32 else None
    got = solve_map(args.device, dtype)
    want = cs.RT_JAX["map"]
    ref = np.asarray(want["sample"])
    rel = np.abs(got.reshape(-1)[::want["sample_stride"]] - ref) / ref
    corner = np.zeros(ref.size, bool)
    corner[want["sample_corner"]] = True
    print(f"map on {args.device} ({'float32' if args.float32 else 'its'} "
          f"geometry) against JAX's every {want['sample_stride']}th cell: "
          f"{rel[~corner].max():.3e} relative on {int((~corner).sum())} "
          f"cells, {int((rel[~corner] > cs.RT_GAIN_RTOL).sum())} above "
          f"{cs.RT_GAIN_RTOL}; {rel[corner].max():.3e} on the "
          f"{int(corner.sum())} a corner path reaches")
    cpu = solve_map("cpu", torch.float64)
    diff = np.abs(got - cpu) / cpu
    bad = np.argwhere(diff > cs.RT_GAIN_RTOL)
    rows = sorted({int(r) for r in bad[:, 0]})
    print(f"against the port on the CPU in float64, all {cpu.size} cells: "
          f"{len(bad)} above {cs.RT_GAIN_RTOL}, largest {diff.max():.3e}; "
          f"rows {rows[:20]}")
    off = np.ones(cpu.shape, bool)
    off[[91, 108]] = False            # y = -8.5 and 8.5: the corner rows
    print(f"  outside the corner rows |y| = 8.5: "
          f"{int((diff[off] > cs.RT_GAIN_RTOL).sum())} above, largest "
          f"{diff[off].max():.3e}")
    ys = np.arange(C["size"][1]) - (C["size"][1] - 1) / 2
    xs = np.arange(C["size"][0]) - (C["size"][0] - 1) / 2
    for k in np.argsort(diff.reshape(-1))[::-1][:3]:
        r, c = divmod(int(k), C["size"][0])
        rx = [float(xs[c]), float(ys[r]), C["center"][2]]
        print(f"cell {rx}: {got[r, c]:.6e} against {cpu[r, c]:.6e}")
        for dev, dt in ((args.device, dtype), ("cpu", torch.float64)):
            print(f"  {dev}: {sorted(path_list(dev, rx, dt).items())}")


if __name__ == "__main__":
    main()
