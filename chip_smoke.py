"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's main paths on the card and checks that they went
through the hand-written CUDA kernels of the lifted LDPC decoder:

1. prints the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds both kernels from ``sionna_tpu_torch/csrc`` (one nvcc each,
   started together);
3. holds the flooding kernel (K1) against its plain torch version, for
   three codes, three check-node rules, 0/1/20 iterations, two SNRs;
4. holds the layered kernel (K3) against its plain torch version, for
   the same codes and rules, 0/1/10 iterations, two SNRs;
5. runs the README quick-start link (5G LDPC k=1024, n=2048, 16-QAM,
   AWGN, APP demapper, BP-20 boxplus, batch 2000) through ``sim_ber`` at
   Eb/N0 3 and 4 dB: BLER bands, every tensor on the card, one K1
   launch per decoder call;
6. runs the flagship link (bench.py:110-131: TDL-A OFDM, 256-FFT grid
   with Kronecker pilots, 16-QAM, LDPC k=6144 n=12288, LS-NN estimation,
   LMMSE, APP demapper, boxplus BP-20, batch 2048) through ``sim_ber``
   at Eb/N0 8 and 5 dB: BLER bands from a JAX run of the same link, every
   tensor on the card, one K1 launch per decoder call;
7. the same link with ``cn_schedule="layered"``, 10 iterations, at
   8 dB: its band, one K3 launch per decoder call;
8. times (CUDA events, warm-up excluded): K1 (BP-20) and K3
   (layered-10) against their plain versions at the flagship's
   n=12288 x 2048 and K1 at the link's n=2048 x 2000, each output
   first held identical to the plain one at that shape; the flagship's
   Mbit/s and per-stage split, the coded-AWGN link's Mbit/s.

Prints the kernels' JSON line (``ms``/``plain_ms`` at the entry's
``shape``), the card again, and last
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sionna_tpu_torch.phy import AWGN, BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import TDL
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RowColumnInterleaver)
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc.decoding import (LAYERED_BP_KERNEL,
                                                    LIFTED_BP_KERNEL,
                                                    layered_bp_cuda,
                                                    lifted_bp_cuda)
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.ofdm import (LMMSEEqualizer, LSChannelEstimator,
                                       ResourceGrid, ResourceGridMapper)
from sionna_tpu_torch.phy.utils import ebnodb2no, sim_ber

LINK = dict(k=1024, n=2048, nbps=4, batch=2000, num_iter=20)
FLAGSHIP = dict(batch=2048, nbps=4, rate=0.5, mc_iter=8)
KERNELS = (LIFTED_BP_KERNEL, LAYERED_BP_KERNEL)

# Flagship BLER bands from the JAX package's run of the same link on the
# CPU (bench._flagship_step with ldpc_engine="lifted", one block per key,
# seeds 0 and 1 pooled): (block errors, blocks) per point. The band is
# the JAX estimate +- 5 standard errors of the difference between it and
# this script's estimate (FLAGSHIP["mc_iter"] x 2048 blocks), the
# variance taken at a rate at least one block away from 0 and 1.
FLAGSHIP_JAX = {("flooding", 8.0): (12171, 24576),
                ("flooding", 5.0): (8192, 8192),
                ("layered", 8.0): (13291, 24576)}


def bler_band(schedule, ebno_db):
    errors, blocks = FLAGSHIP_JAX[(schedule, ebno_db)]
    p = errors / blocks
    q = min(max(p, 1 / blocks), 1 - 1 / blocks)
    n_port = FLAGSHIP["mc_iter"] * FLAGSHIP["batch"]
    half = 5 * (q * (1 - q) * (1 / blocks + 1 / n_port)) ** 0.5
    return max(p - half, 0.0), min(p + half, 1.0)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def reset_launches():
    for kern in KERNELS:
        kern.launches = 0


def noisy_llrs(enc, batch, ebno_db, gen):
    """Random info bits and the logit-convention BPSK LLRs of their
    codewords at ``ebno_db``."""
    dev = enc.device
    b = torch.randint(0, 2, (batch, enc.k), generator=gen, device=dev,
                      dtype=torch.float32)
    c = enc(b)
    no = float(ebnodb2no(ebno_db, 1, enc.coderate))
    y = (1 - 2 * c) + (no / 2) ** 0.5 * torch.randn(
        c.shape, generator=gen, device=dev)
    return b, -4 * y / no


def assert_identical(got, want, what):
    """Raises unless kernel output ``got`` and plain output ``want`` have
    one shape, are finite and are equal (tolerance 0). Returns
    max |got - want| (0)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: kernel output {tuple(got.shape)}, "
                             f"plain {tuple(want.shape)}")
    for name, t in (("kernel", got), ("plain", want)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{what}: {name} output not finite")
    err = float((got - want).abs().max())
    if err != 0.0:
        raise AssertionError(f"{what}: kernel disagrees with plain: {err}")
    return err


def check_kernel_against_plain(dev, layered):
    """Phases 3 and 4: a kernel against its plain version on the card,
    for every check-node rule; the marginals must be identical
    (tolerance 0). Both do the same f32 operations in the same order,
    and the kernels' tanhf/log1pf (no fast math) are the functions
    torch's CUDA tanh/log1p call. Returns max |kernel - plain| (0)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    kernel = layered_bp_cuda if layered else lifted_bp_cuda
    iters = (0, 1, 10) if layered else (0, 1, 20)
    # (k, n, nbps, batch, converging / non-converging Eb/N0 in dB); the
    # plain layered decode launches ~50 small ops per base edge and row,
    # so its n=12288 cases run at a reduced batch
    codes = [(100, 200, None, 256, (5.0, 0.0)),
             (LINK["k"], LINK["n"], LINK["nbps"], LINK["batch"], (3.0, 0.0)),
             (6144, 12288, None, 256 if layered else 2048, (2.5, 0.0))]
    for k, n, nbps, batch, snrs in codes:
        enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
        for cn in ("boxplus", "minsum", "offset-minsum"):
            dec = LDPC5GDecoder(enc, cn_update=cn, device=dev)
            plain = dec.lifted.decode_layered if layered \
                else dec.lifted.decode
            for ebno_db in snrs:
                b, llr = noisy_llrs(enc, batch, ebno_db, gen)
                llr_int = dec.recover_llrs(llr)
                for it in iters:
                    got = kernel(dec.lifted, llr_int, it)
                    want = plain(llr_int, it)
                    err = assert_identical(
                        got, want, f"({k},{n}) {cn} {ebno_db} dB {it} iters")
                    max_err = max(max_err, err)
                    # classic convention: a negative marginal decides 1
                    ber = float(((got[:, :k] < 0).float() != b).float()
                                .mean())
                    print(f"  ({k},{n}) {cn:13s} Eb/N0 {ebno_db:4.1f} dB "
                          f"iters {it:2d}: max|kernel-plain| {err:.3e} "
                          f"(info BER {ber:.2e})")
    return max_err


def make_link(dev):
    k, n, nbps = LINK["k"], LINK["n"], LINK["nbps"]
    src = BinarySource(device=dev)
    enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
    mapper = Mapper("qam", nbps, device=dev)
    demapper = Demapper("app", "qam", nbps, device=dev)
    dec = LDPC5GDecoder(enc, num_iter=LINK["num_iter"], device=dev)
    awgn = AWGN(device=dev)
    seen = {"calls": 0, "devices": set()}

    def run(batch_size, ebno_db):
        b = src([batch_size, k])
        x = mapper(enc(b))
        no = ebnodb2no(ebno_db, nbps, k / n).to(dev)
        y = awgn(x, no)
        llr = demapper(y, no)
        b_hat = dec(llr)
        seen["calls"] += 1
        for t in (b, x, no, y, llr, b_hat):
            seen["devices"].add(t.device.type)
        return b, b_hat

    return run, dec, seen


class Flagship:
    """bench.py's flagship link (bench.py:110-131) on the port's public
    blocks: TDL-A (100 ns, 3.5 GHz, 3 km/h) SISO OFDM, 14 symbols of a
    256-FFT grid at 30 kHz with CP 16 and Kronecker pilots on symbols
    [2, 11], 16-QAM, rate-1/2 5G LDPC (n=12288) with a row-column
    interleaver, LS estimation with nearest-neighbour interpolation,
    LMMSE equalization, APP demapping and a boxplus decoder."""

    def __init__(self, dev, **decoder_kw):
        nbps = FLAGSHIP["nbps"]
        self.dev = dev
        self.rg = rg = ResourceGrid(
            num_ofdm_symbols=14, fft_size=256, subcarrier_spacing=30e3,
            num_tx=1, num_streams_per_tx=1, cyclic_prefix_length=16,
            pilot_pattern="kronecker", pilot_ofdm_symbol_indices=[2, 11])
        n = int(rg.num_data_symbols) * nbps
        self.k = k = int(n * FLAGSHIP["rate"])
        self.src = BinarySource(device=dev)
        self.enc = LDPC5GEncoder(k, n, device=dev)
        self.il = RowColumnInterleaver(row_depth=nbps, device=dev)
        self.dil = Deinterleaver(self.il, device=dev)
        self.mapper = Mapper("qam", nbps, device=dev)
        self.rg_mapper = ResourceGridMapper(rg, device=dev)
        self.channel = OFDMChannel(
            TDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3), rg,
            normalize_channel=True, device=dev)
        self.est = LSChannelEstimator(rg, interpolation_type="nn",
                                      device=dev)
        self.equ = LMMSEEqualizer(rg, StreamManagement(np.array([[1]]), 1),
                                  device=dev)
        self.demapper = Demapper("app", "qam", nbps, device=dev)
        self.dec = LDPC5GDecoder(self.enc, hard_out=True,
                                 cn_update="boxplus", device=dev,
                                 **decoder_kw)
        self.calls = 0
        self.devices = set()

    def no(self, ebno_db):
        return ebnodb2no(ebno_db, FLAGSHIP["nbps"], FLAGSHIP["rate"],
                         self.rg).to(self.dev)

    def __call__(self, batch_size, ebno_db):
        """One MC iteration (the sim_ber model): returns (b, b_hat)."""
        no = self.no(ebno_db)
        b = self.src([batch_size, 1, 1, self.k])
        x_rg = self.rg_mapper(self.mapper(self.il(self.enc(b))))
        y = self.channel(x_rg, no)
        h_hat, err_var = self.est(y, no)
        x_hat, no_eff = self.equ(y, h_hat, err_var, no)
        llr = self.dil(self.demapper(x_hat, no_eff))
        b_hat = self.dec(llr)
        self.calls += 1
        for t in (no, b, x_rg, y, h_hat, err_var, x_hat, no_eff, llr,
                  b_hat):
            self.devices.add(t.device.type)
        return b, b_hat

    def stage_ms(self, batch_size, ebno_db, reps):
        """Mean milliseconds of each stage of one MC iteration, by CUDA
        events around the stages, over ``reps`` iterations after one
        warm-up."""
        names = ["source+encode+map+RG map", "channel generation",
                 "channel application and noise", "LS estimation", "LMMSE",
                 "demap", "decode"]
        total = np.zeros(len(names))
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
            no = self.no(ebno_db)
            ev[0].record()
            b = self.src([batch_size, 1, 1, self.k])
            x_rg = self.rg_mapper(self.mapper(self.il(self.enc(b))))
            ev[1].record()
            h = self.channel.gen(batch_size)
            ev[2].record()
            y = self.channel.app(x_rg, h, no)
            ev[3].record()
            h_hat, err_var = self.est(y, no)
            ev[4].record()
            x_hat, no_eff = self.equ(y, h_hat, err_var, no)
            ev[5].record()
            llr = self.dil(self.demapper(x_hat, no_eff))
            ev[6].record()
            self.dec(llr)
            ev[7].record()
            torch.cuda.synchronize()
            if rep:
                total += [ev[i].elapsed_time(ev[i + 1])
                          for i in range(len(names))]
        return dict(zip(names, total / reps))


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(ker, plain, ker_reps, plain_reps):
    """kernel, plain, plain, kernel: ((k1, k2), (p1, p2)) ms per call."""
    k1 = cuda_ms(ker, ker_reps)
    p1 = cuda_ms(plain, plain_reps)
    p2 = cuda_ms(plain, plain_reps)
    k2 = cuda_ms(ker, ker_reps)
    return (k1, k2), (p1, p2)


def run_flagship(link, schedule, snrs):
    """Phases 6 and 7: the flagship through sim_ber with every launch
    count at 0 just before and read just after. Returns the launches."""
    reset_launches()
    t0 = time.perf_counter()
    _, bler = sim_ber(link, snrs, batch_size=FLAGSHIP["batch"],
                      max_mc_iter=FLAGSHIP["mc_iter"], early_stop=False,
                      verbose=True)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    bler = bler.tolist()
    print(f"    {schedule}: BLER {bler}, {link.calls} decoder calls, "
          f"launches {launches}, devices {sorted(link.devices)}, "
          f"{time.perf_counter() - t0:.2f} s")
    for snr, p in zip(snrs, bler):
        lo, hi = bler_band(schedule, snr)
        if not lo <= p <= hi:
            raise AssertionError(f"flagship {schedule} BLER at {snr} dB "
                                 f"{p} outside [{lo}, {hi}]")
    if link.devices != {"cuda"}:
        raise AssertionError(f"flagship tensors on {link.devices}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda kern: kern.library(), KERNELS))
    print(f"[2] built {', '.join(k.source.name for k in KERNELS)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for kern in KERNELS:
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line or "lmem" in line:
                print(f"    ptxas {kern.name}: {line.strip()}")

    max_err = {}
    for phase, kern, layered in (("[3]", LIFTED_BP_KERNEL, False),
                                 ("[4]", LAYERED_BP_KERNEL, True)):
        print(f"{phase} {kern.name} vs plain torch on the card")
        before = kern.launches
        max_err[kern.name] = check_kernel_against_plain(dev, layered)
        if kern.launches <= before:
            raise AssertionError(f"{phase} did not launch {kern.name}")
        print(f"    all cases identical; max |kernel-plain| "
              f"{max_err[kern.name]:.3e} (tolerance 0)")

    print("[5] coded-AWGN link through sim_ber on the card")
    run, dec, seen = make_link(dev)
    reset_launches()
    t0 = time.perf_counter()
    ber, bler = sim_ber(run, [3.0, 4.0], batch_size=LINK["batch"],
                        max_mc_iter=10, early_stop=False, verbose=True)
    torch.cuda.synchronize()
    link_s = time.perf_counter() - t0
    launches = LIFTED_BP_KERNEL.launches
    ber, bler = ber.tolist(), bler.tolist()
    print(f"    BER {ber}, BLER {bler}, {seen['calls']} decoder calls, "
          f"{launches} kernel launches, devices {sorted(seen['devices'])}, "
          f"{link_s:.2f} s")
    if not 0.4 <= bler[0] <= 0.8:
        raise AssertionError(f"BLER at 3 dB {bler[0]} outside [0.4, 0.8]")
    if not bler[1] <= 0.02:
        raise AssertionError(f"BLER at 4 dB {bler[1]} above 0.02")
    if seen["devices"] != {"cuda"}:
        raise AssertionError(f"link tensors on {seen['devices']}")
    if launches == 0 or launches != seen["calls"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{seen['calls']} decoder calls")

    print("[6] flagship link (BP-20 flooding) through sim_ber on the card")
    flood = Flagship(dev, num_iter=20)
    flood_launches = run_flagship(flood, "flooding", [8.0, 5.0])
    if (flood_launches[LIFTED_BP_KERNEL.name] != flood.calls
            or flood_launches[LAYERED_BP_KERNEL.name] != 0):
        raise AssertionError(f"{flood_launches} for {flood.calls} "
                             "flooding decoder calls")

    print("[7] flagship link (layered, 10 iterations) through sim_ber")
    layered = Flagship(dev, num_iter=10, cn_schedule="layered")
    layered_launches = run_flagship(layered, "layered", [8.0])
    if (layered_launches[LAYERED_BP_KERNEL.name] != layered.calls
            or layered_launches[LIFTED_BP_KERNEL.name] != 0):
        raise AssertionError(f"{layered_launches} for {layered.calls} "
                             "layered decoder calls")

    print(f"[8] times on {card} (warm-up excluded)")
    # both decoders alone at the flagship's code, batch 2048: K1 BP-20
    # flooding, K3 layered-10 (the setting docs/PERFORMANCE.md compares),
    # and K1 at the coded-AWGN link's code and batch; each kernel's
    # output is first held against its plain version at that shape
    gen = torch.Generator(device=dev).manual_seed(2)
    llr_big = flood.dec.recover_llrs(
        noisy_llrs(flood.enc, FLAGSHIP["batch"], 2.5, gen)[1])
    llr_link = dec.recover_llrs(
        noisy_llrs(dec.encoder, LINK["batch"], 3.0, gen)[1])
    times, shapes = {}, {}
    for kern, lift, llr, it, shape in (
            (LIFTED_BP_KERNEL, flood.dec.lifted, llr_big, 20,
             "n=12288 x 2048, BP-20 boxplus"),
            (LAYERED_BP_KERNEL, flood.dec.lifted, llr_big, 10,
             "n=12288 x 2048, layered-10 boxplus"),
            (LIFTED_BP_KERNEL, dec.lifted, llr_link, 20,
             "n=2048 x 2000, BP-20 boxplus")):
        if kern is LAYERED_BP_KERNEL:
            ker, plain = layered_bp_cuda, lift.decode_layered
        else:
            ker, plain = lifted_bp_cuda, lift.decode
        err = assert_identical(ker(lift, llr, it), plain(llr, it),
                               f"{kern.name} at {shape}")
        max_err[kern.name] = max(max_err[kern.name], err)
        (k1, k2), (p1, p2) = in_turns(lambda: ker(lift, llr, it),
                                      lambda: plain(llr, it), 10, 2)
        print(f"    {kern.name}, {shape}: max|kernel-plain| {err:.3e}; "
              f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / "
              f"{p2:.3f} ms per call")
        if kern.name not in times:  # the kernels line: flagship shape
            times[kern.name] = ((k1 + k2) / 2, (p1 + p2) / 2)
            shapes[kern.name] = shape
    ker_ms, plain_ms = times[LIFTED_BP_KERNEL.name]
    print(f"    ldpc_bp_codeword_iterations_per_s: kernel "
          f"{2048 * 20 / ker_ms:.3f} kiter/s, plain "
          f"{2048 * 20 / plain_ms:.3f} kiter/s "
          f"(n=12288, batch 2048, BP-20 boxplus)")

    batch = FLAGSHIP["batch"]
    for name, link in (("flooding BP-20", flood), ("layered-10", layered)):
        ms = cuda_ms(lambda: link(batch, 5.0), 10)
        print(f"    flagship_tdla_mimo_ofdm_info_bit_throughput "
              f"({name}): {batch * link.k / ms / 1e3:.3f} Mbit/s "
              f"({ms:.3f} ms per MC iteration, batch {batch}, Eb/N0 5 dB)")
        stages = link.stage_ms(batch, 5.0, 5)
        tot = sum(stages.values())
        for stage, t in stages.items():
            print(f"      {stage:30s} {t:9.3f} ms  {100 * t / tot:5.1f} %")
        print(f"      {'sum of stages':30s} {tot:9.3f} ms")

    n_iters = 10
    run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"    coded_awgn_ldpc_mc_info_bit_throughput: "
          f"{n_iters * LINK['batch'] * LINK['k'] / dt / 1e6:.3f} Mbit/s "
          f"(k=1024, n=2048, 16-QAM, BP-20, batch 2000, Eb/N0 4 dB, "
          f"{dt / n_iters * 1e3:.3f} ms per MC iteration)")

    main_launches = {LIFTED_BP_KERNEL.name: flood_launches,
                     LAYERED_BP_KERNEL.name: layered_launches}
    print(json.dumps({"kernels": [{
        "name": kern.name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + kern.source.name,
        "replaces": kern.replaces,
        "launches": main_launches[kern.name][kern.name],
        "max_abs_err": max_err[kern.name],
        "shape": shapes[kern.name],
        "ms": times[kern.name][0],
        "plain_ms": times[kern.name][1],
    } for kern in KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
