"""BASELINE config 4 on the PyTorch port: ray-traced paths and a radio
coverage map.

Solves propagation paths (LoS + specular reflections + first-order UTD
wedge diffraction + diffuse scattering) in a street-canyon scene, prints
the strongest paths of the CIR, and computes a radio map. Runs on the
card (``config.device``) unless ``--cpu`` or ``SIONNA_TPU_EXAMPLES_CPU``
asks for the CPU; ``SIONNA_TPU_EXAMPLES_FAST`` shrinks the ray counts.

Usage (from the repository root):
    PYTHONPATH=. python sionna_tpu_torch/examples/04_rt_coverage_map.py
"""

import os
import sys

import numpy as np

from sionna_tpu_torch.phy import config
from sionna_tpu_torch.rt import (load_scene, Transmitter, Receiver,
                                 PlanarArray, PathSolver, RadioMapSolver)

CPU = "--cpu" in sys.argv or bool(os.environ.get("SIONNA_TPU_EXAMPLES_CPU"))
FAST = bool(os.environ.get("SIONNA_TPU_EXAMPLES_FAST"))


def main():
    if CPU:
        config.device = "cpu"
    scene = load_scene("simple_street_canyon", frequency=3.5e9)
    scene.tx_array = PlanarArray(1, 2, pattern="iso", polarization="V")
    scene.rx_array = PlanarArray(1, 2, pattern="iso", polarization="V")
    scene.add(Transmitter("tx", [-20., 0., 10.]))
    scene.add(Receiver("rx", [20., 5., 1.5]))

    # make the concrete surfaces slightly rough so diffuse scattering
    # contributes paths
    scene.get("itu_concrete").scattering_coefficient = 0.3

    paths = PathSolver()(scene, max_depth=2 if FAST else 3,
                         samples_per_src=5_000 if FAST else 50_000,
                         diffraction=True, diffuse_reflection=True,
                         diffuse_samples=256 if FAST else 2048)
    a, tau = paths.cir(out_type="numpy")
    amps = np.abs(a[0, 0, 0, 0, :, 0])
    v = amps > 0
    print(f"paths found: {int(v.sum())} (incl. diffracted + scattered)")
    order = np.argsort(-amps[v])[:12]      # strongest 12
    for d, g in zip(tau[0, 0][v][order] * 3e8,
                    20 * np.log10(amps[v][order] + 1e-30)):
        print(f"  path length {d:7.2f} m  gain {g:7.2f} dB")

    rm = RadioMapSolver()(scene, cell_size=(4., 4.) if FAST else (2., 2.),
                          max_depth=2,
                          samples_per_src=5_000 if FAST else 20_000)
    pg = rm.path_gain[0].cpu().numpy()
    pg_db = 10 * np.log10(pg + 1e-30)
    print(f"radio map: {pg.shape[0]}x{pg.shape[1]} cells, median path gain "
          f"{np.median(pg_db[pg > 0]):.1f} dB, coverage(>-120 dB) "
          f"{(pg_db > -120).mean() * 100:.1f}%")


if __name__ == "__main__":
    main()
