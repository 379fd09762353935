"""References of BASELINE config 5 (the SYS multi-cell simulation), run by
the JAX package on the CPU: what ``chip_smoke.py`` phases 20-22 hold the
PyTorch port's run on the card against.

- ``--part slots`` (phase 20): ``bench.bench_sys`` (``bench.py:414-484``)
  with ``config.seed = SLOTS_SEED`` before the drop:
  ``gen_hexgrid_topology(1, num_rings=1, num_ut_per_sector=4, "umi")``
  (21 sectors, 84 UTs), the distance-proxy SINR, ``PHYAbstraction()``,
  ``OuterLoopLinkAdaptation(bler_target=0.1)``, 1000 REs per UT; its
  jitted 50-slot scan, extended to count the NACKs. Repetition ``r`` of
  ``--reps`` runs bench's three timed calls from the initial OLLA state,
  the state carried, under ``PRNGKey(1000 * r + 2 + c)``; the script
  prints the NACKs and HARQ outcomes pooled over the repetitions, and
  the SHA-256 of the drop's arrays (``topology_sha256``).
- ``--part gain`` (phase 21): with ``config.seed = GAIN_SEED`` before the
  drop, ``gen_hexgrid_topology(1, num_rings=1, num_ut_per_sector=10,
  "umi")`` (21 sectors, 210 UTs) and ``UMi(3.5e9, "low", omni, omni,
  "downlink")`` (one V-polarized omnidirectional element each,
  ``tests/test_sys.py:353-364``) given that drop. Repetition ``r`` draws
  the frozen LSPs under ``PRNGKey(2 * r)`` and one channel of 14 OFDM
  symbols at 30 kHz under ``PRNGKey(2 * r + 1)``, then
  ``cir_to_ofdm_channel`` over 612 subcarriers; each of the 4,410 links'
  gain is the mean of |h|^2 over symbols and subcarriers, in dB. It
  prints the mean and standard deviation over the links of each
  repetition, and their means and spreads over the repetitions.
- ``--part bler`` (phase 22): ``PHYAbstraction.new_bler_table`` for
  PUSCH (category 0), MCS table 1, code block size 1000, at each MCS of
  ``BLER_POINTS`` its three SNRs, ``--batch`` blocks per call and
  ``--iters`` calls per point (no early stop), ``config.seed = BLER_SEED
  + r`` for repetition ``r``: the block errors and blocks per point,
  pooled. ``--scan`` prints the BLER over a wider SNR range instead.

Each part prints one JSON line. The constants of ``chip_smoke.py`` come
from, at the repository root::

    PYTHONPATH=. python tools/sys_ref.py --part slots --reps 20
    PYTHONPATH=. python tools/sys_ref.py --part gain --reps 16
    PYTHONPATH=. python tools/sys_ref.py --part bler --batch 2000 \\
        --iters 10 --reps 2

(about 1, 3.5 and 10 minutes on 8 CPU cores).
"""

import argparse
import hashlib
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sionna_tpu.phy import config  # noqa: E402
from sionna_tpu.phy.channel import (cir_to_ofdm_channel,  # noqa: E402
                                    subcarrier_frequencies)
from sionna_tpu.phy.channel.tr38901 import PanelArray, UMi  # noqa: E402
from sionna_tpu.sys import (OuterLoopLinkAdaptation,  # noqa: E402
                            PHYAbstraction, gen_hexgrid_topology)

SLOTS_SEED = 0
GAIN_SEED = 1
BLER_SEED = 2
# PUSCH (category 0), MCS table 1, CBS 1000: three SNRs [dB] around each
# MCS's waterfall (found with --scan)
BLER_POINTS = {5: (-1.0, -0.75, -0.5), 14: (6.5, 6.75, 7.0),
               20: (12.0, 12.5, 13.0)}
BLER_CBS = 1000


def topology_sha256(topology):
    """SHA-256 over the drop's arrays (the ``los`` entry, None, left
    out), each as C-contiguous bytes of its own dtype."""
    h = hashlib.sha256()
    for x in topology:
        if x is not None:
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def slots(reps, n_slots=50):
    """Phase 20's reference (``bench.bench_sys``'s loop)."""
    config.seed = SLOTS_SEED
    topo = gen_hexgrid_topology(batch_size=1, num_rings=1,
                                num_ut_per_sector=4, scenario="umi")
    ut_loc, bs_loc = topo[:2]
    num_ut = ut_loc.shape[1]
    d = np.linalg.norm(np.asarray(ut_loc)[0][:, None]
                       - np.asarray(bs_loc)[0][None], axis=-1)
    serving = d.min(axis=1)
    interf = d.sum(axis=1) - serving
    sinr_base = (interf / serving) ** 2 / bs_loc.shape[1]
    phy_abs = PHYAbstraction()
    olla = OuterLoopLinkAdaptation(phy_abs, num_ut, bler_target=0.1)
    n_re_j = jnp.asarray(np.full((num_ut,), 1000), jnp.int32)
    sinr_base_j = jnp.asarray(sinr_base, jnp.float32)

    @jax.jit
    def run_slots(state, key):
        def body(carry, s):
            state, harq = carry
            kk = jax.random.fold_in(key, s)
            k1, k2 = jax.random.split(kk)
            sinr_eff = sinr_base_j * jax.random.exponential(
                k1, (num_ut,), jnp.float32)
            state, mcs = olla.step(state, n_re_j, harq_feedback=harq,
                                   sinr_eff=sinr_eff)
            bits, harq_j, *_ = phy_abs(mcs, sinr_eff=sinr_eff,
                                       num_allocated_re=n_re_j, key=k2)
            return (state, harq_j), (jnp.sum(bits), jnp.sum(harq_j == 0))

        harq0 = jnp.full((num_ut,), -1, jnp.int32)
        (state, _), (bits, nacks) = jax.lax.scan(
            body, (state, harq0), jnp.arange(n_slots))
        return state, jnp.sum(bits), jnp.sum(nacks)

    nacks = outcomes = 0
    for r in range(reps):
        state = olla.init_state()
        for c in range(3):
            state, _, n = run_slots(state,
                                    jax.random.PRNGKey(1000 * r + 2 + c))
            nacks += int(n)
            outcomes += n_slots * num_ut
    return {"part": "slots", "seed": SLOTS_SEED, "num_ut": num_ut,
            "nacks": nacks, "outcomes": outcomes,
            "topology_sha256": topology_sha256(topo)}


def omni():
    return PanelArray(num_rows_per_panel=1, num_cols_per_panel=1,
                      polarization="single", polarization_type="V",
                      antenna_pattern="omni", carrier_frequency=3.5e9)


def gain(reps, chunk=10):
    """Phase 21's reference: link-gain statistics of the UMi drop."""
    config.seed = GAIN_SEED
    topo = gen_hexgrid_topology(batch_size=1, num_rings=1,
                                num_ut_per_sector=10, scenario="umi")
    model = UMi(3.5e9, "low", omni(), omni(), "downlink")
    model.set_topology(*topo)
    freqs = subcarrier_frequencies(612, 30e3)

    @jax.jit
    def link_gain(a, tau):
        h = cir_to_ofdm_channel(freqs, a, tau)
        return jnp.mean(jnp.abs(h) ** 2, axis=(2, 4, 5, 6))

    means, stds = [], []
    for r in range(reps):
        model._lsp = model._lsp_sampler(key=jax.random.PRNGKey(2 * r))
        # traced anew: a jitted call would keep the first trace's LSPs,
        # which it holds as constants
        a, tau = jax.jit(lambda k: model(14, 30e3, key=k))(
            jax.random.PRNGKey(2 * r + 1))
        g = np.concatenate([np.asarray(link_gain(a[:, i:i + chunk],
                                                 tau[:, i:i + chunk]))
                            for i in range(0, a.shape[1], chunk)], axis=1)
        g_db = 10 * np.log10(g.reshape(-1))
        means.append(float(g_db.mean()))
        stds.append(float(g_db.std()))
        print(f"rep {r}: mean {means[-1]:.4f} dB, std {stds[-1]:.4f} dB",
              flush=True)
    return {"part": "gain", "seed": GAIN_SEED, "links": int(g.size),
            "means": means, "stds": stds,
            "mean_of_means": float(np.mean(means)),
            "spread_of_means": float(np.std(means, ddof=1)),
            "mean_of_stds": float(np.mean(stds)),
            "spread_of_stds": float(np.std(stds, ddof=1)),
            "topology_sha256": topology_sha256(topo)}


def bler(reps, batch, iters, scan):
    """Phase 22's reference: new BLER table points."""
    out = {}
    for mcs, snrs in BLER_POINTS.items():
        if scan:
            snrs = tuple(float(s) for s in
                         np.arange(snrs[0] - 1.0, snrs[-1] + 1.01, 0.5))
        errors = np.zeros(len(snrs), np.int64)
        blocks = 0
        for r in range(reps):
            config.seed = BLER_SEED + r
            phy_abs = PHYAbstraction()
            table = phy_abs.new_bler_table(
                list(snrs), [BLER_CBS],
                {"category": {0: {"index": {1: {"MCS": [mcs]}}}}},
                batch_size=batch, max_mc_iter=iters, early_stop=False,
                verbose=False)
            b = table["category"][0]["index"][1]["MCS"][mcs]["CBS"][
                BLER_CBS]["BLER"]
            errors += np.rint(np.asarray(b) * batch * iters).astype(np.int64)
            blocks += batch * iters
        out[mcs] = {"snr_db": list(snrs), "errors": errors.tolist(),
                    "blocks": blocks}
        print(mcs, out[mcs], flush=True)
    return {"part": "bler", "cbs": BLER_CBS, "points": out}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--part", choices=("slots", "gain", "bler"),
                   required=True)
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--batch", type=int, default=2000)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--scan", action="store_true")
    args = p.parse_args()
    t0 = time.time()
    if args.part == "slots":
        res = slots(args.reps)
    elif args.part == "gain":
        res = gain(args.reps)
    else:
        res = bler(args.reps, args.batch, args.iters, args.scan)
    res["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
