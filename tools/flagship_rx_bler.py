"""BLER of the flagship TDL-A OFDM link's receiver variants, run by the
JAX package on the CPU: the reference that ``chip_smoke.py`` phase 14
holds the PyTorch port's BLER against (``chip_smoke.bler_band``).

The link is ``bench._flagship_step``'s (256-FFT grid, 14 symbols,
Kronecker pilots on symbols 2 and 11, 16-QAM, 5G LDPC k=6144 n=12288
with a row-column interleaver, TDL-A 100 ns at 3.5 GHz and 3 km/h,
boxplus BP-20 on the lifted engine) with the receiver swapped:

- ``lin_lmmse``: LS with linear interpolation, LMMSE equalizer;
- ``lintavg_zf``: LS with time-averaged linear interpolation, ZF;
- ``lmmse_lmmse``: LS with ``LMMSEInterpolator("t-f")`` built from the
  TDL-A frequency and time covariance matrices, LMMSE equalizer;
- ``nn_mf``: LS with nearest-neighbour interpolation, MF equalizer.

Each jitted call decodes ``--batch`` blocks under key
``PRNGKey(seed * 100000 + i)``; the script prints one JSON line per
variant with the block errors and blocks. The bands of ``chip_smoke.py``
pool, from the repository root::

    for seed in 0 1; do PYTHONPATH=. python tools/flagship_rx_bler.py \
        --variant nn_mf --variant lin_lmmse --variant lintavg_zf \
        --blocks 8192 --batch 64 --seed $seed; done
    for seed in 0 1 2 3 4 5 6 7; do PYTHONPATH=. python \
        tools/flagship_rx_bler.py --variant lmmse_lmmse --blocks 4096 \
        --batch 16 --seed $seed; done

(about 1.5 minutes per 8192 blocks of the first three, 6-12 minutes per
4096 of the last, on 8 CPU cores).
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

from sionna_tpu.phy import BinarySource, Demapper, Mapper  # noqa: E402
from sionna_tpu.phy.channel import OFDMChannel  # noqa: E402
from sionna_tpu.phy.channel.tr38901 import TDL  # noqa: E402
from sionna_tpu.phy.fec.interleaving import (Deinterleaver,  # noqa: E402
                                             RowColumnInterleaver)
from sionna_tpu.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder  # noqa: E402
from sionna_tpu.phy.mimo import StreamManagement  # noqa: E402
from sionna_tpu.phy.ofdm import (LMMSEEqualizer, LMMSEInterpolator,  # noqa: E402
                                 LSChannelEstimator, MFEqualizer,
                                 ResourceGrid, ResourceGridMapper,
                                 ZFEqualizer, tdl_freq_cov_mat,
                                 tdl_time_cov_mat)
from sionna_tpu.phy.utils import ebnodb2no  # noqa: E402

VARIANTS = ("lin_lmmse", "lintavg_zf", "lmmse_lmmse", "nn_mf")
NBPS, RATE, SPEED = 4, 0.5, 3 / 3.6


def receiver(variant, rg, sm):
    """(estimator, equalizer) of ``variant``."""
    if variant == "lmmse_lmmse":
        cov_f = tdl_freq_cov_mat("A", 30e3, rg.fft_size, 100e-9)
        cov_t = tdl_time_cov_mat("A", SPEED, 3.5e9, rg.ofdm_symbol_duration,
                                 rg.num_ofdm_symbols)
        est = LSChannelEstimator(rg, interpolator=LMMSEInterpolator(
            rg.pilot_pattern, cov_t, cov_f, order="t-f"))
    else:
        est = LSChannelEstimator(rg, interpolation_type={
            "lin_lmmse": "lin", "lintavg_zf": "lin_time_avg",
            "nn_mf": "nn"}[variant])
    equ = {"lin_lmmse": LMMSEEqualizer, "lintavg_zf": ZFEqualizer,
           "lmmse_lmmse": LMMSEEqualizer, "nn_mf": MFEqualizer}[variant]
    return est, equ(rg, sm)


def link(variant, batch):
    """A jitted (ebno_db, key) -> block errors of ``batch`` blocks."""
    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=256,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=1, cyclic_prefix_length=16,
                      pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11])
    sm = StreamManagement(np.array([[1]]), 1)
    n = int(rg.num_data_symbols) * NBPS
    k = int(n * RATE)
    src = BinarySource()
    enc = LDPC5GEncoder(k, n)
    il = RowColumnInterleaver(row_depth=NBPS)
    dil = Deinterleaver(il)
    mapper = Mapper("qam", NBPS)
    rg_mapper = ResourceGridMapper(rg)
    channel = OFDMChannel(TDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3),
                          rg, normalize_channel=True)
    est, equ = receiver(variant, rg, sm)
    demapper = Demapper("app", "qam", NBPS)
    dec = LDPC5GDecoder(enc, hard_out=True, cn_update="boxplus",
                        num_iter=20, engine="lifted")

    @jax.jit
    def run(ebno_db, key):
        no = ebnodb2no(ebno_db, NBPS, RATE, rg)
        k1, k2 = jax.random.split(key)
        b = src([batch, 1, 1, k], key=k1)
        y = channel(rg_mapper(mapper(il(enc(b)))), no, key=k2)
        h_hat, err_var = est(y, no)
        x_hat, no_eff = equ(y, h_hat, err_var, no)
        b_hat = dec(dil(demapper(x_hat, no_eff)))
        return jnp.sum(jnp.any(b != b_hat, axis=-1))

    return run


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", choices=VARIANTS, action="append")
    p.add_argument("--blocks", type=int, default=4096)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--ebno-db", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    for variant in args.variant or VARIANTS:
        run = link(variant, args.batch)
        t0 = time.perf_counter()
        errors = blocks = 0
        for i in range(args.blocks // args.batch):
            key = jax.random.PRNGKey(args.seed * 100000 + i)
            errors += int(run(jnp.float32(args.ebno_db), key))
            blocks += args.batch
        print(json.dumps({"variant": variant, "ebno_db": args.ebno_db,
                          "seed": args.seed, "block_errors": errors,
                          "blocks": blocks,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
