"""BLER of the MIMO-OFDM links over 3GPP CDL (BASELINE config 3 and its
variants), run by the JAX package on the CPU: the reference that
``chip_smoke.py`` phases 17-19 hold the PyTorch port's BLER against
(``chip_smoke.bler_band``).

Links (one block is one codeword of one stream):

- ``ul_freq``: ``examples/03_mimo_ofdm_cdl.py`` at its widths: a 128-FFT
  grid at 30 kHz, 14 symbols, Kronecker pilots on symbols 2 and 11, one
  transmitter with 4 streams; UT and BS ``AntennaArray(1, 2, "dual",
  "cross", "38.901", 3.5e9)``; CDL-B at 100 ns and 3.5 GHz, uplink, 3
  m/s, ``OFDMChannel(normalize_channel=True)``; 16-QAM, 5G LDPC k=3072
  n=6144; LS with linear interpolation, ``LinearDetector("lmmse", "bit",
  "app")``, ``LDPC5GDecoder(num_iter=12, cn_update="minsum")``.
- ``dl_time``: the ``Model`` of ``tests/test_integration_mimo_ofdm.py``
  (downlink, time domain, estimated CSI) at the widths of ``ul_freq``:
  the same arrays, CDL and code on its grid (the Model's cyclic
  prefix 6 and DC null, guard carriers [2, 1], a multiple of 4
  subcarriers left for the 4 streams' Kronecker pilots: k=2976
  n=5952); RZF precoding from the
  frequency response at the start of each symbol, ``OFDMModulator``,
  ``cir_to_time_channel`` (normalised) and ``ApplyTimeChannel``,
  ``OFDMDemodulator``; LS with nearest-neighbour interpolation, LMMSE
  equalizer, APP demapper, ``LDPC5GDecoder`` (boxplus-phi, 20
  iterations).
- ``det_<name>``: ``tests/test_integration_detectors.py`` at a 128-FFT
  grid (15 kHz, 14 symbols, no pilots, 4 streams): CDL-A at 100 ns and
  2.6 GHz, uplink, 3 m/s, UT ``AntennaArray(1, 2, ...)`` and BS
  ``AntennaArray(1, 4, ...)`` (4 x 8), QPSK, 5G LDPC k=1792 n=3584,
  perfect CSI, the detector ``lmmse`` (``LinearDetector("lmmse", "bit",
  "maxlog")``), ``kbest`` (k=16), ``ep`` (l=10), ``mmsepic`` (3
  iterations) or ``ml`` (maxlog), bit output, ``LDPC5GDecoder``
  (boxplus-phi, 20 iterations).

Each jitted call decodes ``--batch`` grids (4 blocks each) under key
``PRNGKey(seed * 100000 + i)`` at ``--ebno-db`` (default: the link's
point in ``EBNO_DB``); the script prints one JSON line per link with the
block errors and blocks. ``--scan`` prints the BLER at several points
instead (one call each). The bands of ``chip_smoke.py`` pool seeds 0
and 1, from the repository root::

    for seed in 0 1; do
      PYTHONPATH=. python tools/mimo_ofdm_cdl_bler.py --link ul_freq \
          --blocks 32768 --batch 32 --seed $seed
      PYTHONPATH=. python tools/mimo_ofdm_cdl_bler.py --link dl_time \
          --blocks 8192 --batch 8 --seed $seed
      PYTHONPATH=. python tools/mimo_ofdm_cdl_bler.py --link det_lmmse \
          --link det_kbest --link det_ep --link det_mmsepic \
          --link det_ml --blocks 8192 --batch 16 --seed $seed
    done

(about 2, 5-7 and 8 minutes per seed on 8 CPU cores).
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
from sionna_tpu.phy.channel import (ApplyTimeChannel, OFDMChannel,  # noqa: E402
                                    cir_to_ofdm_channel, cir_to_time_channel,
                                    subcarrier_frequencies,
                                    time_lag_discrete_time_channel)
from sionna_tpu.phy.channel.tr38901 import CDL, AntennaArray  # noqa: E402
from sionna_tpu.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder  # noqa: E402
from sionna_tpu.phy.mimo import StreamManagement  # noqa: E402
from sionna_tpu.phy.ofdm import (EPDetector, KBestDetector,  # noqa: E402
                                 LinearDetector, LMMSEEqualizer,
                                 LSChannelEstimator,
                                 MaximumLikelihoodDetector, MMSEPICDetector,
                                 OFDMDemodulator, OFDMModulator,
                                 ResourceGrid, ResourceGridMapper,
                                 RZFPrecoder)
from sionna_tpu.phy.utils import ebnodb2no  # noqa: E402

DETECTORS = ("lmmse", "kbest", "ep", "mmsepic", "ml")
LINKS = ("ul_freq", "dl_time") + tuple(f"det_{d}" for d in DETECTORS)
# The Eb/N0 (dB) of each link's band: where the JAX BLER lies between
# 0.05 and 0.6 (found with --scan)
EBNO_DB = {"ul_freq": 8.0, "dl_time": 10.0, "det_lmmse": -2.0,
           "det_kbest": -6.0, "det_ep": -4.0, "det_mmsepic": -2.0,
           "det_ml": -6.0}
NUM_STREAMS = 4


def cross_array(num_cols, fc):
    return AntennaArray(num_rows=1, num_cols=num_cols, polarization="dual",
                        polarization_type="cross", antenna_pattern="38.901",
                        carrier_frequency=fc)


def ul_freq(batch):
    """The uplink frequency-domain link (BASELINE config 3)."""
    nbps, rate = 4, 0.5
    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=128,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=NUM_STREAMS,
                      pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11])
    sm = StreamManagement(np.array([[1]]), NUM_STREAMS)
    n = int(rg.num_data_symbols) * nbps
    k = int(n * rate)
    cdl = CDL("B", 100e-9, 3.5e9, cross_array(2, 3.5e9),
              cross_array(2, 3.5e9), "uplink", min_speed=3.)
    src = BinarySource()
    enc = LDPC5GEncoder(k, n)
    mapper = Mapper("qam", nbps)
    rg_mapper = ResourceGridMapper(rg)
    channel = OFDMChannel(cdl, rg, normalize_channel=True)
    est = LSChannelEstimator(rg, interpolation_type="lin")
    det = LinearDetector("lmmse", "bit", "app", rg, sm, "qam", nbps)
    dec = LDPC5GDecoder(enc, num_iter=12, cn_update="minsum")

    def run(ebno_db, key):
        k1, k2 = jax.random.split(key)
        no = ebnodb2no(ebno_db, nbps, rate, rg)
        b = src([batch, 1, NUM_STREAMS, k], key=k1)
        y = channel(rg_mapper(mapper(enc(b))), no, key=k2)
        h_hat, err_var = est(y, no)
        return b, dec(det(y, h_hat, err_var, no))

    return run


def dl_time(batch):
    """The downlink time-domain link with RZF precoding."""
    nbps, rate, cp = 4, 0.5, 6
    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=128,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=NUM_STREAMS,
                      cyclic_prefix_length=cp, num_guard_carriers=[2, 1],
                      dc_null=True, pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11])
    sm = StreamManagement(np.array([[1]]), NUM_STREAMS)
    n = int(rg.num_data_symbols) * nbps
    k = int(n * rate)
    cdl = CDL("B", 100e-9, 3.5e9, cross_array(2, 3.5e9),
              cross_array(2, 3.5e9), "downlink", min_speed=3.)
    freqs = subcarrier_frequencies(rg.fft_size, rg.subcarrier_spacing)
    l_min, l_max = time_lag_discrete_time_channel(rg.bandwidth)
    l_tot = l_max - l_min + 1
    src = BinarySource()
    enc = LDPC5GEncoder(k, n)
    mapper = Mapper("qam", nbps)
    rg_mapper = ResourceGridMapper(rg)
    precoder = RZFPrecoder(rg, sm, return_effective_channel=True)
    modulator = OFDMModulator(cp)
    demodulator = OFDMDemodulator(rg.fft_size, l_min, cp)
    channel = ApplyTimeChannel(rg.num_time_samples, l_tot=l_tot)
    est = LSChannelEstimator(rg, interpolation_type="nn")
    equ = LMMSEEqualizer(rg, sm)
    demapper = Demapper("app", "qam", nbps)
    dec = LDPC5GDecoder(enc, hard_out=True)

    def run(ebno_db, key):
        k1, k2, k3 = jax.random.split(key, 3)
        no = ebnodb2no(ebno_db, nbps, rate, rg)
        b = src([batch, 1, NUM_STREAMS, k], key=k1)
        x_rg = rg_mapper(mapper(enc(b)))
        a, tau = cdl(batch, rg.num_time_samples + l_tot - 1, rg.bandwidth,
                     key=k2)
        h_time = cir_to_time_channel(rg.bandwidth, a, tau, l_min=l_min,
                                     l_max=l_max, normalize=True)
        a_freq = a[..., cp:-1:(rg.fft_size + cp)][..., :rg.num_ofdm_symbols]
        h_freq = cir_to_ofdm_channel(freqs, a_freq, tau, normalize=True)
        x_rg, _ = precoder(x_rg, h_freq)
        y = demodulator(channel(modulator(x_rg), h_time, no, key=k3))
        h_hat, err_var = est(y, no)
        x_hat, no_eff = equ(y, h_hat, err_var, no)
        return b, dec(demapper(x_hat, no_eff))

    return run


def detector(name, rg, sm, nbps):
    """The detector of ``det_<name>`` (bit output)."""
    if name == "lmmse":
        return LinearDetector("lmmse", "bit", "maxlog", rg, sm, "qam", nbps)
    if name == "kbest":
        return KBestDetector("bit", NUM_STREAMS, 16, rg, sm, "qam", nbps)
    if name == "ep":
        return EPDetector("bit", rg, sm, nbps)
    if name == "mmsepic":
        return MMSEPICDetector("bit", rg, sm, num_iter=3,
                               constellation_type="qam",
                               num_bits_per_symbol=nbps)
    return MaximumLikelihoodDetector("bit", "maxlog", rg, sm, "qam", nbps)


def detectors(name, batch):
    """The detector link ``det_<name>``."""
    nbps, fc = 2, 2.6e9
    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=128,
                      subcarrier_spacing=15e3, num_tx=1,
                      num_streams_per_tx=NUM_STREAMS)
    sm = StreamManagement(np.array([[1]]), NUM_STREAMS)
    n = int(rg.num_data_symbols) * nbps
    k = n // 2
    cdl = CDL("A", 100e-9, fc, cross_array(2, fc), cross_array(4, fc),
              "uplink", min_speed=3.)
    channel = OFDMChannel(cdl, rg, normalize_channel=True,
                          return_channel=True)
    det = detector(name, rg, sm, nbps)
    src = BinarySource()
    enc = LDPC5GEncoder(k, n)
    mapper = Mapper("qam", nbps)
    rg_mapper = ResourceGridMapper(rg)
    dec = LDPC5GDecoder(enc, hard_out=True)

    def run(ebno_db, key):
        k1, k2 = jax.random.split(key)
        no = ebnodb2no(ebno_db, nbps, 0.5, rg)
        b = src([batch, 1, NUM_STREAMS, k], key=k1)
        y, h = channel(rg_mapper(mapper(enc(b))), no, key=k2)
        err_var = jnp.zeros((), jnp.float32)
        if name == "mmsepic":
            llr = det(y, h, None, err_var, no)
        else:
            llr = det(y, h, err_var, no)
        return b, dec(llr)

    return run


def link(name, batch):
    """A jitted (ebno_db, key) -> block errors of ``batch`` grids."""
    if name == "ul_freq":
        run = ul_freq(batch)
    elif name == "dl_time":
        run = dl_time(batch)
    else:
        run = detectors(name[4:], batch)

    @jax.jit
    def errors(ebno_db, key):
        b, b_hat = run(ebno_db, key)
        return jnp.sum(jnp.any(b != b_hat, axis=-1))

    return errors


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--link", choices=LINKS, action="append")
    p.add_argument("--blocks", type=int, default=2048)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--ebno-db", type=float)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan", type=float, nargs="+",
                   help="print the BLER of one call at each Eb/N0")
    args = p.parse_args()
    for name in args.link or LINKS:
        run = link(name, args.batch)
        if args.scan:
            for ebno_db in args.scan:
                t0 = time.perf_counter()
                err = int(run(jnp.float32(ebno_db), jax.random.PRNGKey(7)))
                print(json.dumps({"link": name, "ebno_db": ebno_db,
                                  "bler": err / (NUM_STREAMS * args.batch),
                                  "seconds": round(time.perf_counter() - t0,
                                                   1)}), flush=True)
            continue
        ebno_db = EBNO_DB[name] if args.ebno_db is None else args.ebno_db
        t0 = time.perf_counter()
        errors = blocks = 0
        for i in range(args.blocks // (NUM_STREAMS * args.batch)):
            key = jax.random.PRNGKey(args.seed * 100000 + i)
            errors += int(run(jnp.float32(ebno_db), key))
            blocks += NUM_STREAMS * args.batch
        print(json.dumps({"link": name, "ebno_db": ebno_db,
                          "seed": args.seed, "batch": args.batch,
                          "block_errors": errors, "blocks": blocks,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
