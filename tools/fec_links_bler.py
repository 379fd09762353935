"""BLER of the polar, convolutional and turbo links, run by the JAX
package on the CPU: the references that ``chip_smoke.py`` phases 15 and
16 hold the PyTorch port's BLER against (``chip_smoke.bler_band``).

Every link sends QPSK over AWGN with an APP demapper:

- ``polar_sc``, ``polar_scl8``: ``bench.bench_polar``'s link (BASELINE
  config 2), ``Polar5GEncoder(512, 1024)`` (uplink, CRC11, no rate
  matching) and ``Polar5GDecoder`` SC, or SCL with ``list_size=8`` and
  the default ``use_spc=True``;
- ``conv_viterbi``, ``conv_bcjr``: a terminated rate-1/2,
  constraint-length-7 ``ConvEncoder`` (k=1024) with ``ViterbiDecoder``
  (soft LLRs) or ``BCJRDecoder`` (map);
- ``turbo``: a terminated rate-1/3 ``TurboEncoder`` with constraint
  length 4 (the 3GPP code, k=1024) and ``TurboDecoder``, 6 iterations.

Each jitted call sends ``--batch`` blocks under key
``PRNGKey(seed * 100000 + i)``; the script prints one JSON line per link
with the block errors and blocks at ``--ebno-db`` (default: the link's
point in ``EBNO_DB``). The bands of ``chip_smoke.py`` pool, from the
repository root::

    PYTHONPATH=. python tools/fec_links_bler.py --link polar_sc \
        --link conv_viterbi --link conv_bcjr --link turbo --blocks 32768 \
        --batch 2048 --seed 0
    for seed in 1 2 3; do PYTHONPATH=. python tools/fec_links_bler.py \
        --link polar_sc --blocks 32768 --batch 2048 --seed $seed; done
    for seed in 0 1 2 3 4 5; do PYTHONPATH=. python \
        tools/fec_links_bler.py --link polar_scl8 --blocks 16384 \
        --batch 1024 --seed $seed; done

(on 8 CPU cores: about 10 s per 32768 SC blocks, 35 s per 16384 SCL-8
blocks, 23 s, 17 minutes and 5 minutes per 32768 blocks of Viterbi,
BCJR and turbo).
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sionna_tpu.phy import AWGN, BinarySource, Demapper, Mapper  # noqa: E402
from sionna_tpu.phy.fec.conv import (BCJRDecoder, ConvEncoder,  # noqa: E402
                                     ViterbiDecoder)
from sionna_tpu.phy.fec.polar import Polar5GDecoder, Polar5GEncoder  # noqa: E402
from sionna_tpu.phy.fec.turbo import TurboDecoder, TurboEncoder  # noqa: E402
from sionna_tpu.phy.utils import ebnodb2no  # noqa: E402

LINKS = ("polar_sc", "polar_scl8", "conv_viterbi", "conv_bcjr", "turbo")
# Each link's Eb/N0 in dB: a BLER between about 0.05 and 0.5
EBNO_DB = {"polar_sc": 1.5, "polar_scl8": 1.0, "conv_viterbi": 2.5,
           "conv_bcjr": 2.5, "turbo": 0.3}
K_CONV = 1024


def codec(link):
    """(encoder, decoder, k, coderate) of ``link``."""
    if link.startswith("polar"):
        enc = Polar5GEncoder(512, 1024)
        dec = Polar5GDecoder(enc, dec_type="SC") if link == "polar_sc" \
            else Polar5GDecoder(enc, dec_type="SCL", list_size=8)
        return enc, dec, 512, 512 / 1024
    if link.startswith("conv"):
        enc = ConvEncoder(rate=1 / 2, constraint_length=7, terminate=True)
        dec = ViterbiDecoder(encoder=enc) if link == "conv_viterbi" \
            else BCJRDecoder(encoder=enc)
        return enc, dec, K_CONV, 1 / 2
    enc = TurboEncoder(rate=1 / 3, constraint_length=4, terminate=True)
    return enc, TurboDecoder(enc, num_iter=6), K_CONV, 1 / 3


def make_link(link, batch):
    """A jitted (ebno_db, key) -> block errors of ``batch`` blocks."""
    enc, dec, k, rate = codec(link)
    src = BinarySource()
    mapper, demapper, awgn = Mapper("qam", 2), Demapper("app", "qam", 2), \
        AWGN()

    @jax.jit
    def run(ebno_db, key):
        no = ebnodb2no(ebno_db, 2, rate)
        k1, k2 = jax.random.split(key)
        u = src([batch, k], key=k1)
        y = awgn(mapper(enc(u)), no, key=k2)
        u_hat = dec(demapper(y, no))
        return jnp.sum(jnp.any(u != u_hat, axis=-1))

    return run


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--link", choices=LINKS, action="append")
    p.add_argument("--blocks", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--ebno-db", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    for link in args.link or LINKS:
        ebno_db = EBNO_DB[link] if args.ebno_db is None else args.ebno_db
        run = make_link(link, args.batch)
        t0 = time.perf_counter()
        errors = blocks = 0
        for i in range(args.blocks // args.batch):
            key = jax.random.PRNGKey(args.seed * 100000 + i)
            errors += int(run(jnp.float32(ebno_db), key))
            blocks += args.batch
        print(json.dumps({"link": link, "ebno_db": ebno_db,
                          "seed": args.seed, "block_errors": errors,
                          "blocks": blocks,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
