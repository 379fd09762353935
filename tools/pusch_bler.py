"""TB BLER of the 5G NR PUSCH link over 3GPP CDL-B, run by the JAX package
on the CPU: the reference that ``chip_smoke.py`` phase 24 holds the
PyTorch port's BLER against (``chip_smoke.bler_band``).

The link is the PUSCH tutorial's (``docs/tutorials/04_5g_nr_pusch.md``):
a carrier of 16 PRBs at 30 kHz, 2 antenna ports, 2 layers, codebook
precoding with TPMI 1, DMRS type 1 with one additional position, MCS 14
of table 1 (16-QAM, a 9,992-bit transport block in two code blocks).
The channel is BASELINE config 3's CDL (``examples/03_mimo_ofdm_cdl.py``):
CDL-B at 100 ns and 3.5 GHz, uplink, 3 m/s, a UE array of one
dual-polarized 38.901 element (the 2 antenna ports) and the BS array
``AntennaArray(1, 2, "dual", "cross", "38.901", 3.5e9)`` (4 antennas),
through ``OFDMChannel(normalize_channel=True)`` with AWGN at
``no = ebnodb2no(ebno_db, 4, pc.tb.target_coderate, rg)``. The receiver
is ``PUSCHReceiver``'s default: LS estimation with linear
interpolation, ``LinearDetector("lmmse", "bit", "maxlog")``,
``TBDecoder`` (boxplus-phi, 20 iterations). One block is one transport
block.

Each jitted call sends ``--batch`` transport blocks under key
``PRNGKey(seed * 100000 + i)`` at ``--ebno-db`` (default ``EBNO_DB``);
the script prints one JSON line with the block errors and blocks.
``--scan`` prints the BLER of one call at several points instead. The
band of ``chip_smoke.py`` (``PUSCH_JAX``) pools seeds 0 and 1, from the
repository root::

    for seed in 0 1; do
      PYTHONPATH=. python tools/pusch_bler.py --blocks 10240 --batch 256 \\
          --seed $seed
    done

At 3.5 dB this gave 1142 (seed 0) and 1150 (seed 1) TB errors of 10240
TBs each, about 200 s per seed on 8 CPU cores.
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sionna_tpu.phy.channel import OFDMChannel  # noqa: E402
from sionna_tpu.phy.channel.tr38901 import CDL, AntennaArray  # noqa: E402
from sionna_tpu.phy.nr import (PUSCHConfig, PUSCHReceiver,  # noqa: E402
                               PUSCHTransmitter)
from sionna_tpu.phy.utils import ebnodb2no  # noqa: E402

# The Eb/N0 (dB) of the band: on the waterfall, where the JAX BLER lies
# near 0.1 (found with --scan)
EBNO_DB = 3.5
FC = 3.5e9


def tutorial_config():
    """The PUSCH tutorial's configuration (16 PRBs)."""
    pc = PUSCHConfig()
    pc.carrier.subcarrier_spacing = 30
    pc.carrier.n_size_grid = 16
    pc.num_antenna_ports = 2
    pc.num_layers = 2
    pc.precoding = "codebook"
    pc.tpmi = 1
    pc.dmrs.config_type = 1
    pc.dmrs.additional_position = 1
    pc.tb.mcs_index = 14
    return pc


def link(batch):
    """A jitted (ebno_db, key) -> TB errors of ``batch`` transport
    blocks."""
    pc = tutorial_config()
    tx = PUSCHTransmitter(pc)
    rx = PUSCHReceiver(tx)
    rg = tx.resource_grid
    ut = AntennaArray(num_rows=1, num_cols=1, polarization="dual",
                      polarization_type="cross", antenna_pattern="38.901",
                      carrier_frequency=FC)
    bs = AntennaArray(num_rows=1, num_cols=2, polarization="dual",
                      polarization_type="cross", antenna_pattern="38.901",
                      carrier_frequency=FC)
    cdl = CDL("B", 100e-9, FC, ut, bs, "uplink", min_speed=3.)
    channel = OFDMChannel(cdl, rg, normalize_channel=True)

    @jax.jit
    def errors(ebno_db, key):
        k1, k2 = jax.random.split(key)
        no = ebnodb2no(ebno_db, pc.tb.num_bits_per_symbol,
                       pc.tb.target_coderate, rg)
        x, b = tx(batch, key=k1)
        b_hat = rx(channel(x, no, key=k2), no)
        return jnp.sum(jnp.any(b != b_hat, axis=-1))

    return errors


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--blocks", type=int, default=1024)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ebno-db", type=float, default=EBNO_DB)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan", type=float, nargs="+",
                   help="print the BLER of one call at each Eb/N0")
    args = p.parse_args()
    run = link(args.batch)
    if args.scan:
        for ebno_db in args.scan:
            t0 = time.perf_counter()
            err = int(run(jnp.float32(ebno_db), jax.random.PRNGKey(7)))
            print(json.dumps({"ebno_db": ebno_db, "bler": err / args.batch,
                              "seconds": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        return
    t0 = time.perf_counter()
    errors = blocks = 0
    for i in range(args.blocks // args.batch):
        key = jax.random.PRNGKey(args.seed * 100000 + i)
        errors += int(run(jnp.float32(args.ebno_db), key))
        blocks += args.batch
    print(json.dumps({"link": "pusch_cdl_b", "ebno_db": args.ebno_db,
                      "seed": args.seed, "batch": args.batch,
                      "block_errors": errors, "blocks": blocks,
                      "seconds": round(time.perf_counter() - t0, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
