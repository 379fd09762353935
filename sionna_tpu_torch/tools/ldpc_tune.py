"""LDPC decoder-kernel tuning sweep at the flagship code, on a CUDA card.

The port's counterpart of ``tools/ldpc_tune.py``: decoder-only time per
call and throughput (codeword-iterations/s) of the lifted BP kernels at
the flagship workload (5G LDPC BG1, k=6144, n=12288, boxplus, batch
2048) across their knobs:

- flooding BP-20 (``csrc/ldpc_lifted_bp.cu``): f32 messages, f32 with
  the ratio form of the boxplus magnitude, bf16 v2c storage;
- layered-10 (``csrc/ldpc_layered_bp.cu``): f32 and bf16 c2v storage;
- without ``--quick``, the plain torch flooding decode as well.

Run on a machine with a card: ``python -m sionna_tpu_torch.tools.ldpc_tune
[--quick]``. Each call is timed with CUDA events over several calls after
a warm-up call. Each variant prints a weighted hard-decision checksum
``sig``, the count of ones, and the share of hard decisions that differ
from the f32 variant of the same schedule on the probe LLRs.
"""

import argparse

import torch

from ..phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from ..phy.fec.ldpc.decoding import layered_bp_cuda, lifted_bp_cuda

K, N = 6144, 12288
BATCH = 2048
NUM_ITER = 20
LAYERED_ITER = 10
REPS = 5
# Every kernel variant the sweep times: label -> (schedule, knobs of
# lifted_bp_cuda / layered_bp_cuda and of their plain versions)
KERNEL_VARIANTS = {
    "K1 f32": ("flooding", {}),
    "K1 f32 ratio": ("flooding", dict(atanh_form="ratio")),
    "K1 bf16": ("flooding", dict(storage_dtype=torch.bfloat16)),
    "K3 layered f32": ("layered", {}),
    "K3 layered bf16": ("layered", dict(storage_dtype=torch.bfloat16)),
}


def variants(lifted, quick=True):
    """[(label, schedule, iterations, call)]; each call takes the LLRs
    and returns the marginals."""
    rows = []
    for label, (schedule, knobs) in KERNEL_VARIANTS.items():
        if schedule == "layered":
            rows.append((label, schedule, LAYERED_ITER,
                         lambda x, kw=knobs: layered_bp_cuda(
                             lifted, x, LAYERED_ITER, **kw)))
        else:
            rows.append((label, schedule, NUM_ITER,
                         lambda x, kw=knobs: lifted_bp_cuda(
                             lifted, x, NUM_ITER, **kw)))
    if not quick:
        rows.append(("plain f32", "flooding", NUM_ITER,
                     lambda x: lifted.decode(x, NUM_ITER)))
    return rows


def checksum(hard):
    """(sig, ones): the hard decisions weighted by (column index mod 97)
    + 1, and their count."""
    hard = hard.to(torch.float64)
    w = torch.arange(hard.shape[1], device=hard.device,
                     dtype=torch.float64) % 97 + 1
    return float((hard * w).sum()), float(hard.sum())


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


def sweep(quick=True):
    """Times every variant on the probe LLRs ([BATCH, num_vns], 3 times
    a standard normal draw from seed 0) on the first card and prints one
    line each. Returns {label: (ms per call, kiter/s, sig, ones, flips)};
    flips is the share of hard decisions (a negative marginal decides 1)
    that differ from the first variant of the same schedule (f32)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the LDPC tuning sweep needs a CUDA device")
    device = torch.device("cuda", 0)
    enc = LDPC5GEncoder(K, N, device=device)
    lifted = LDPC5GDecoder(enc, hard_out=True, cn_update="boxplus",
                           num_iter=NUM_ITER, engine="pallas",
                           device=device).lifted
    gen = torch.Generator(device=device).manual_seed(0)
    llr = torch.randn(BATCH, lifted._num_vns, generator=gen,
                      device=device) * 3.0
    print(f"z={lifted._z} edges={len(lifted._edges)} "
          f"col_blocks={lifted._n_col_blocks} num_vns={lifted._num_vns} "
          f"batch={BATCH} iters={NUM_ITER} (layered {LAYERED_ITER}) on "
          f"{torch.cuda.get_device_name(device)}", flush=True)
    results, ref = {}, {}
    with torch.no_grad():
        for label, schedule, iters, call in variants(lifted, quick):
            ms = cuda_ms(lambda: call(llr), 1 if label == "plain f32"
                         else REPS)
            hard = call(llr) < 0
            sig, ones = checksum(hard)
            ref_label, ref_hard = ref.setdefault(schedule, (label, hard))
            flips = float((hard != ref_hard).float().mean())
            kiter = BATCH * iters / ms
            print(f"{label:18s} {ms:9.3f} ms {kiter:9.1f} kiter/s  "
                  f"sig={sig:.0f} ones={ones:.0f} flips={flips:.3e} "
                  f"against {ref_label}", flush=True)
            results[label] = (ms, kiter, sig, ones, flips)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="leave out the plain torch decode")
    args = parser.parse_args(argv)
    sweep(quick=args.quick)


if __name__ == "__main__":
    main()
