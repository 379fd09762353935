"""BASELINE config 5 on the PyTorch port: system-level multi-cell
simulation.

Hexagonal grid, a distance-based SINR faded per slot, PHY abstraction
(EESM + BLER tables), outer-loop link adaptation over a slot loop. The
loop runs eagerly, one slot after the other, on the card
(``config.device``) unless ``--cpu`` or ``SIONNA_TPU_EXAMPLES_CPU`` asks
for the CPU; nothing is read back until the loop ends.
``SIONNA_TPU_EXAMPLES_FAST`` shrinks the drop and the slot count.

Usage (from the repository root):
    PYTHONPATH=. python sionna_tpu_torch/examples/05_sys_multicell.py
"""

import os
import sys

import numpy as np
import torch

from sionna_tpu_torch.sys import (PHYAbstraction, OuterLoopLinkAdaptation,
                                  gen_hexgrid_topology)
from sionna_tpu_torch.phy import config

CPU = "--cpu" in sys.argv or bool(os.environ.get("SIONNA_TPU_EXAMPLES_CPU"))
FAST = bool(os.environ.get("SIONNA_TPU_EXAMPLES_FAST"))


def main():
    if CPU:
        config.device = "cpu"
    config.seed = 42
    num_rings = 1
    num_cells = 3 * (1 + num_rings * (num_rings + 1))
    num_ut_per_cell = 2 if FAST else 4
    n_slots = 5 if FAST else 20

    # Hexagonal multi-cell topology with wraparound
    ut_loc, bs_loc, *_ = gen_hexgrid_topology(
        batch_size=1, num_rings=num_rings,
        num_ut_per_sector=num_ut_per_cell, scenario="umi")
    num_bs = bs_loc.shape[1]
    num_ut = ut_loc.shape[1]
    print(f"topology: {num_bs} sites, {num_ut} UTs "
          f"({num_cells} cells x {num_ut_per_cell} UT)")

    # Distance-based SINR proxy for the slot loop (a full UMi channel
    # through LMMSEPostEqualizationSINR plugs in here; see
    # sionna_tpu_torch/tools/sys_slots.py for that wiring)
    d = np.linalg.norm(np.asarray(ut_loc)[0][:, None]
                       - np.asarray(bs_loc)[0][None], axis=-1)
    serving = d.min(axis=1)
    interf = d.sum(axis=1) - serving
    sinr_eff_base = (interf / serving) ** 2 / num_bs

    phy_abs = PHYAbstraction()
    dev = phy_abs.device
    olla = OuterLoopLinkAdaptation(phy_abs, num_ut, bler_target=0.1)
    n_re = torch.full((num_ut,), 1000, dtype=torch.int32, device=dev)
    base = torch.as_tensor(sinr_eff_base, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100)

    # The slot loop: fading draw -> OLLA (its functional step) -> ILLA ->
    # PHY abstraction -> HARQ feedback into the next slot
    state = olla.init_state()
    harq = torch.full((num_ut,), -1, dtype=torch.int32, device=dev)
    bits, acks = [], []
    for _ in range(n_slots):
        fading = torch.empty(num_ut, device=dev).exponential_(generator=gen)
        sinr_eff = base * fading
        state, mcs = olla.step(state, n_re, harq_feedback=harq,
                               sinr_eff=sinr_eff)
        b, harq, *_ = phy_abs(mcs, sinr_eff=sinr_eff, num_allocated_re=n_re,
                              generator=gen)
        bits.append(b.sum())
        acks.append((harq == 1).sum())
    bits = torch.stack(bits).cpu().numpy()
    acks = torch.stack(acks).cpu().numpy()
    for s in range(n_slots):
        print(f"slot {s:3d}: {int(acks[s])}/{num_ut} ACK, "
              f"{bits[s] / 1e3:.1f} kbit delivered")
    print(f"total: {bits.sum() / 1e6:.2f} Mbit over {n_slots} slots "
          f"(eager slot loop on {dev})")


if __name__ == "__main__":
    main()
