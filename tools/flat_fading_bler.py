"""BLER of the two coded links over memoryless channels that
``chip_smoke.py`` phase 26 runs, by the JAX package on the CPU: the
references its bands hold the PyTorch port to (``FLAT_JAX``).

- ``mimo``: coded MIMO over spatially correlated flat fading, the chain
  of ``tests/test_integration_extra.py`` (the reference's
  ``test_mimo_flat_fading.py`` and ``Simple_MIMO_Simulation`` tutorial)
  at the tutorial's widths: 4 transmit and 16 receive antennas,
  ``KroneckerModel(exp_corr_mat(0.4, 4), exp_corr_mat(0.9, 16))``, each
  antenna sending its own codeword of ``LDPC5GEncoder(512, 1024)`` (BG2,
  Z=64) in 16-QAM, ``FlatFadingChannel(return_channel=True)`` with AWGN
  at ``no = ebnodb2no(ebno_db, 4, 0.5) * sqrt(16)``, ``lmmse_equalizer``,
  the APP demapper and ``LDPC5GDecoder`` (boxplus, 20 iterations, hard
  decisions). One batch element is four codewords; a block is one
  codeword.
- ``bsc``: the same code over ``BinarySymmetricChannel(return_llrs=True)``
  at flip probability ``pb`` into the same decoder; a batch element is
  one codeword.

Each jitted call sends ``--batch`` batch elements under key
``PRNGKey(seed * 100000 + i)``; the script prints one JSON line with
the block errors and blocks. ``--scan`` prints the BLER of one call at
several points instead. ``chip_smoke.py``'s bands pool seeds 0 and 1,
from the repository root::

    for seed in 0 1; do
      PYTHONPATH=. python tools/flat_fading_bler.py --link mimo \\
          --blocks 65536 --batch 1024 --seed $seed
      PYTHONPATH=. python tools/flat_fading_bler.py --link bsc \\
          --blocks 65536 --batch 4096 --seed $seed
    done
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sionna_tpu.phy.channel import (BinarySymmetricChannel,  # noqa: E402
                                    FlatFadingChannel, KroneckerModel)
from sionna_tpu.phy.channel.utils import exp_corr_mat  # noqa: E402
from sionna_tpu.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder  # noqa: E402
from sionna_tpu.phy.mapping import (BinarySource, Demapper,  # noqa: E402
                                    Mapper)
from sionna_tpu.phy.mimo import lmmse_equalizer  # noqa: E402
from sionna_tpu.phy.utils import ebnodb2no  # noqa: E402

K, N, NBPS, NUM_TX, NUM_RX = 512, 1024, 4, 4, 16
# The points of the bands: on the waterfall, where the JAX BLER lies
# between 0.1 and 0.6 (found with --scan)
POINTS = {"mimo": 3.5, "bsc": 0.085}


def link(kind, batch):
    """A jitted (point, key) -> block errors of ``batch`` batch elements
    of link ``kind`` at Eb/N0 ``point`` dB (mimo) or flip probability
    ``point`` (bsc)."""
    src = BinarySource()
    enc = LDPC5GEncoder(K, N)
    dec = LDPC5GDecoder(enc, hard_out=True)
    if kind == "bsc":
        bsc = BinarySymmetricChannel(return_llrs=True)

        @jax.jit
        def errors(pb, key):
            k1, k2 = jax.random.split(key)
            b = src([batch, K], key=k1)
            b_hat = dec(bsc(enc(b), pb, key=k2))
            return jnp.sum(jnp.any(b != b_hat, axis=-1))

        return errors

    mapper = Mapper("qam", NBPS)
    demapper = Demapper("app", "qam", NBPS)
    corr = KroneckerModel(exp_corr_mat(0.4, NUM_TX),
                          exp_corr_mat(0.9, NUM_RX))
    channel = FlatFadingChannel(NUM_TX, NUM_RX, spatial_corr=corr,
                                return_channel=True)

    @jax.jit
    def errors(ebno_db, key):
        k1, k2 = jax.random.split(key)
        b = src([batch, NUM_TX, K], key=k1)
        x = mapper(enc(b))
        shape = x.shape
        x = jnp.reshape(x, (-1, NUM_TX))
        no = ebnodb2no(ebno_db, NBPS, K / N) * np.sqrt(NUM_RX)
        y, h = channel(x, no, key=k2)
        s = (no * jnp.eye(NUM_RX)).astype(jnp.complex64)
        x_hat, no_eff = lmmse_equalizer(y, h, s)
        b_hat = dec(demapper(jnp.reshape(x_hat, shape),
                             jnp.reshape(no_eff, shape)))
        return jnp.sum(jnp.any(b != b_hat, axis=-1))

    return errors


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--link", choices=sorted(POINTS), required=True)
    p.add_argument("--blocks", type=int, default=4096,
                   help="codewords (a multiple of the codewords per call)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--point", type=float,
                   help="Eb/N0 in dB (mimo) or flip probability (bsc); "
                        "default: POINTS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan", type=float, nargs="+",
                   help="print the BLER of one call at each point")
    args = p.parse_args()
    run = link(args.link, args.batch)
    per_call = args.batch * (NUM_TX if args.link == "mimo" else 1)
    if args.scan:
        for point in args.scan:
            t0 = time.perf_counter()
            err = int(run(jnp.float32(point), jax.random.PRNGKey(7)))
            print(json.dumps({"link": args.link, "point": point,
                              "bler": err / per_call,
                              "seconds": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        return
    point = POINTS[args.link] if args.point is None else args.point
    t0 = time.perf_counter()
    errors = blocks = 0
    for i in range(args.blocks // per_call):
        key = jax.random.PRNGKey(args.seed * 100000 + i)
        errors += int(run(jnp.float32(point), key))
        blocks += per_call
    print(json.dumps({"link": args.link, "point": point, "seed": args.seed,
                      "batch": args.batch, "block_errors": errors,
                      "blocks": blocks,
                      "seconds": round(time.perf_counter() - t0, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
