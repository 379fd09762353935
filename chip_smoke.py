"""Smoke test of the PyTorch port on one CUDA card (an H100).

Runs the port's main path, the README quick-start link (5G LDPC k=1024,
n=2048, 16-QAM with the output interleaver, AWGN, APP demapper, BP-20
boxplus-phi, batch 2000, through ``sim_ber``), on the card, and checks
that it went through the hand-written CUDA kernel of the lifted BP
decoder:

1. prints the card (``nvidia-smi``) and the torch/CUDA versions;
2. builds the kernel from ``sionna_tpu_torch/csrc`` with nvcc;
3. holds the kernel against its plain torch version on the card, for
   three codes, three check-node rules, 0/1/20 iterations and two SNRs;
4. runs the link through ``sim_ber`` at Eb/N0 3 and 4 dB, checks the
   BLER bands, that every tensor is on the card and that each decoder
   call launched the kernel once;
5. times the kernel and the plain version (decoder alone, and the link).

Prints the kernels' JSON line, the card again, and last
``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time

import torch

from sionna_tpu_torch.phy import AWGN, BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.fec.ldpc.decoding import (LIFTED_BP_KERNEL,
                                                    lifted_bp_cuda)
from sionna_tpu_torch.phy.utils import ebnodb2no, sim_ber

LINK = dict(k=1024, n=2048, nbps=4, batch=2000, num_iter=20)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


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


def check_kernel_against_plain(dev):
    """Phase 3: kernel against plain on the card, for every check-node
    rule; the marginals must be identical (tolerance 0). Both do the same
    f32 operations in the same order, and the kernel's tanhf/log1pf (no
    fast math) are the functions torch's CUDA tanh/log1p call. Returns
    max |kernel - plain| (0)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = 0.0
    # (k, n, nbps, batch, converging / non-converging Eb/N0 in dB)
    codes = [(100, 200, None, 256, (5.0, 0.0)),
             (LINK["k"], LINK["n"], LINK["nbps"], LINK["batch"], (3.0, 0.0)),
             (6144, 12288, None, 2048, (2.5, 0.0))]
    for k, n, nbps, batch, snrs in codes:
        enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps, device=dev)
        for cn in ("boxplus", "minsum", "offset-minsum"):
            dec = LDPC5GDecoder(enc, cn_update=cn, device=dev)
            for ebno_db in snrs:
                b, llr = noisy_llrs(enc, batch, ebno_db, gen)
                llr_int = dec.recover_llrs(llr)
                for it in (0, 1, 20):
                    got = lifted_bp_cuda(dec.lifted, llr_int, it)
                    want = dec.lifted.decode(llr_int, it)
                    torch.cuda.synchronize()
                    if got.shape != want.shape or not bool(
                            torch.isfinite(got).all()):
                        raise AssertionError(
                            f"kernel output malformed: {tuple(got.shape)}")
                    err = float((got - want).abs().max())
                    max_err = max(max_err, err)
                    # classic convention: a negative marginal decides 1
                    ber = float(((got[:, :k] < 0).float() != b).float()
                                .mean())
                    print(f"  ({k},{n}) {cn:13s} Eb/N0 {ebno_db:4.1f} dB "
                          f"iters {it:2d}: max|kernel-plain| {err:.3e} "
                          f"(info BER {ber:.2e})")
                    if err != 0.0:
                        raise AssertionError(
                            f"kernel disagrees with plain: ({k},{n}) {cn} "
                            f"{ebno_db} dB {it} iters: {err}")
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
    LIFTED_BP_KERNEL.library()
    print(f"[2] built {LIFTED_BP_KERNEL.source.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in LIFTED_BP_KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "lmem" in line:
            print(f"    ptxas: {line.strip()}")

    print("[3] kernel vs plain torch on the card")
    before = LIFTED_BP_KERNEL.launches
    max_err = check_kernel_against_plain(dev)
    if LIFTED_BP_KERNEL.launches <= before:
        raise AssertionError("phase 3 did not launch the kernel")
    print(f"    all cases identical; max |kernel-plain| {max_err:.3e} "
          "(tolerance 0)")

    print("[4] coded-AWGN link through sim_ber on the card")
    run, dec, seen = make_link(dev)
    LIFTED_BP_KERNEL.launches = 0
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

    print(f"[5] times on {card} (warm-up excluded)")
    # decoder alone at the n=12288 code, batch 2048, BP-20 boxplus
    gen = torch.Generator(device=dev).manual_seed(2)
    enc_big = LDPC5GEncoder(6144, 12288, device=dev)
    dec_big = LDPC5GDecoder(enc_big, cn_update="boxplus", num_iter=20,
                            device=dev)
    llr_big = dec_big.recover_llrs(noisy_llrs(enc_big, 2048, 2.5, gen)[1])
    # the link's decoder at its own shape (batch 2000, BP-20 boxplus)
    enc_link = dec.encoder
    llr_link = dec.recover_llrs(
        noisy_llrs(enc_link, LINK["batch"], 3.0, gen)[1])
    times = {}
    for name, d, llr in (("n12288", dec_big, llr_big),
                         ("link", dec, llr_link)):
        ker = lambda d=d, llr=llr: lifted_bp_cuda(d.lifted, llr, 20)
        plain = lambda d=d, llr=llr: d.lifted.decode(llr, 20)
        # in turns: kernel, plain, plain, kernel
        k1 = cuda_ms(ker, 10)
        p1 = cuda_ms(plain, 2)
        p2 = cuda_ms(plain, 2)
        k2 = cuda_ms(ker, 10)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"    decoder {name}: kernel {k1:.3f} / {k2:.3f} ms, "
              f"plain {p1:.3f} / {p2:.3f} ms per BP-20 call")
    ker_ms, plain_ms = times["n12288"]
    print(f"    ldpc_bp_codeword_iterations_per_s: kernel "
          f"{2048 * 20 / ker_ms:.3f} kiter/s, plain "
          f"{2048 * 20 / plain_ms:.3f} kiter/s "
          f"(n=12288, batch 2048, BP-20 boxplus)")
    n_iters = 10
    run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        b, b_hat = run(LINK["batch"], 4.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"    coded_awgn_ldpc_mc_info_bit_throughput: "
          f"{n_iters * LINK['batch'] * LINK['k'] / dt / 1e6:.3f} Mbit/s "
          f"(k=1024, n=2048, 16-QAM, BP-20, batch 2000, Eb/N0 4 dB, "
          f"{dt / n_iters * 1e3:.3f} ms per MC iteration)")

    ker_link, plain_link = times["link"]
    print(json.dumps({"kernels": [{
        "name": LIFTED_BP_KERNEL.name,
        "route": "cuda",
        "source": "sionna_tpu_torch/csrc/" + LIFTED_BP_KERNEL.source.name,
        "replaces": LIFTED_BP_KERNEL.replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ker_link,
        "plain_ms": plain_link,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
