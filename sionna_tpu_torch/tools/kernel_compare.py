"""Times the lifted BP kernels of this tree against those of another
checkout (e.g. the parent commit's), in turns on one card.

K3 (layered-10, boxplus): f32 and bf16 c2v storage at the flagship code
n=12288 at batch 2048 and at BG1 with Z=384, n=16896 and n=25344 (the
largest 5G code) at batch 2048, and f32 at the coded-AWGN code n=2048 at
batch 2000. K1 (BP-20, f32, boxplus) at the flagship shape. The gradient's
tape kernels K5f (BP-20) and K5Lf (layered-10) and backward kernels K5b
and K5Lb, boxplus, at the coded-AWGN link's n=2048 x 2000 and the
flagship's n=12288 x 2048. The other checkout's package is imported
beside this one (as ``sionna_tpu_torch_other``; the package's imports
are relative) and runs through its own ``layered_bp_cuda``,
``lifted_bp_cuda``, ``flooding_tape_cuda``, ``layered_tape_cuda``,
``flooding_reverse_cuda`` and ``layered_reverse_cuda``, which build its
kernels from its own sources into its own ``build/``.

First it prints ptxas's registers, stack and spill of every kernel of
both checkouts' libraries that the cases use, entry by entry. For each
K1/K3 case it checks that both kernels give this tree's plain decode's
marginals exactly; for each K5f/K5Lf case, that both give this tree's
plain tape forward's marginals and tapes exactly; for each K5b/K5Lb
case, on one tape and one dL/dmarg (this tree's K5f/K5Lf), that both
give this tree's plain reverse's gradient within ``GRAD_REL_TOL`` of its
largest value, and it prints their largest difference from each other.
Then it times them in the order other, this, this, other (CUDA events,
one warm-up, ``--reps`` calls each); a code the other checkout's layout
refuses is timed on this tree's kernel alone. Prints one JSON line per
case (with this tree's layout of the kernel). Then it times this tree's
K3 f32 at the coded-AWGN shape with 1-5 threads per lane, in the order
1..5, 5..1 (the layout's choice at that code is one), and prints the
card.

Run on the card from the repository root, with the other checkout's
package and LDPC tables unpacked under ``build/`` (gitignored), e.g.
``git archive <commit> sionna_tpu_torch sionna_tpu/phy/fec/ldpc/codes |
tar -x -C build/parent``:
``python -m sionna_tpu_torch.tools.kernel_compare --parent build/parent``
(``--kernels K5f K5Lf K5b K5Lb`` for the gradient kernels alone).
"""

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from ..phy.fec.ldpc import lifted_grad as lg
from ..phy.fec.ldpc.decoding import (LAYERED_BP_KERNEL, LIFTED_BP_KERNEL,
                                     layered_bp_cuda, lifted_bp_cuda)
from ..phy.utils import ebnodb2no
from .ldpc_tune import cuda_ms

# (k, n, bits per symbol, batch, Eb/N0 dB)
SHAPES = {"n=12288 x 2048": (6144, 12288, None, 2048, 2.5),
          "n=2048 x 2000": (1024, 2048, 4, 2000, 3.0),
          "n=16896 x 2048": (8448, 16896, None, 2048, 2.5),
          "n=25344 x 2048": (8448, 25344, None, 2048, 1.5)}
# (kernel, storage, shape) of every case
CASES = [("K3", None, "n=12288 x 2048"),
         ("K3", torch.bfloat16, "n=12288 x 2048"),
         ("K3", None, "n=2048 x 2000"),
         ("K3", None, "n=16896 x 2048"),
         ("K3", torch.bfloat16, "n=16896 x 2048"),
         ("K3", None, "n=25344 x 2048"),
         ("K3", torch.bfloat16, "n=25344 x 2048"),
         ("K1", None, "n=12288 x 2048"),
         ("K5f", None, "n=2048 x 2000"),
         ("K5Lf", None, "n=2048 x 2000"),
         ("K5f", None, "n=12288 x 2048"),
         ("K5Lf", None, "n=12288 x 2048"),
         ("K5b", None, "n=2048 x 2000"),
         ("K5Lb", None, "n=2048 x 2000"),
         ("K5b", None, "n=12288 x 2048"),
         ("K5Lb", None, "n=12288 x 2048")]
OTHER = "sionna_tpu_torch_other"
# a backward kernel against the plain reverse on the same tape: the
# largest |error| over the largest |gradient| (f32 sums of the same
# terms in other orders); chip_smoke.py's phase 36 holds them to it too
GRAD_REL_TOL = 1e-6


def other_package(root):
    """The LDPC decoding module of the checkout at ``root``, imported as
    ``sionna_tpu_torch_other.phy.fec.ldpc``."""
    init = Path(root).resolve() / "sionna_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)
    importlib.import_module(f"{OTHER}.phy.fec.ldpc.lifted_grad")
    return importlib.import_module(f"{OTHER}.phy.fec.ldpc")


def k3_thread_sweep(lift, x, reps):
    """{threads: [ms, ms]} of K3 f32 layered-10 on LLRs x with m = 1..5
    threads per lane, timed in the order 1..5, 5..1, each held identical
    to the plain decode (the layout's thread count replaced for the
    sweep, then restored)."""
    base = lift.k3_layout(None)
    want = lift.decode_layered(x, 10)
    times = {}
    try:
        for m in [*range(1, 6), *range(5, 0, -1)]:
            threads = m * base.lanes
            lift._k3_layouts[None] = base._replace(threads=threads)
            identical(layered_bp_cuda(lift, x, 10), want,
                      f"K3 f32 at {threads} threads")
            times.setdefault(threads, []).append(
                cuda_ms(lambda: layered_bp_cuda(lift, x, 10), reps))
    finally:
        lift._k3_layouts[None] = base
    return times


def check_grads(grads, want, what):
    """Raises unless each of ``grads`` ({name: gradient}) is finite and
    within GRAD_REL_TOL of the largest |gradient| of the plain reverse's
    ``want``; returns {name: max |grad - want| / max |want|}."""
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    out = {}
    for name, got in grads.items():
        err = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and
                err <= GRAD_REL_TOL * scale):
            raise AssertionError(f"{what}: {name} off the plain reverse by "
                                 f"{err} of {scale}")
        out[name] = err / scale
    return out


def in_turns(reps, first, second):
    """([ms, ms], [ms, ms]) of ``first`` and ``second``, timed in the
    order first, second, second, first."""
    a1, b1 = cuda_ms(first, reps), cuda_ms(second, reps)
    b2, a2 = cuda_ms(second, reps), cuda_ms(first, reps)
    return [a1, a2], [b1, b2]


def identical(got, want, what):
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got).all()) and torch.equal(got, want)):
        raise AssertionError(f"{what}: not identical to the plain decode")


def llrs(dec, batch, ebno_db, gen):
    enc = dec.encoder
    b = torch.randint(0, 2, (batch, enc.k), generator=gen, device="cuda",
                      dtype=torch.float32)
    c = enc(b)
    no = float(ebnodb2no(ebno_db, 1, enc.coderate))
    y = (1 - 2 * c) + (no / 2) ** 0.5 * torch.randn(
        c.shape, generator=gen, device="cuda")
    return dec.recover_llrs(-4 * y / no)


def entry_name(mangled):
    """A kernel's mangled name without its translation unit's anonymous
    namespace, which carries a hash of the file."""
    return re.sub(r"(?<=_ZN)\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_"
                  r"[0-9a-f]{8}", "", mangled)


def ptxas_figures(kern):
    """{entry: ptxas's registers, stack and spill figures} of each kernel
    in the library of ``kern`` (built), by mangled entry name
    (``entry_name``)."""
    out, entry = {}, None
    for line in (kern.build_log or "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = entry_name(m.group(1))
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return {e: "; ".join(v) for e, v in out.items()}


def kept(out, name, fn):
    """A call of ``fn`` that leaves its output at ``out[name]``, the last
    call's output freed before it starts."""
    def call():
        out.pop(name, None)
        out[name] = fn()
    return call


def tape_case(kernel, shape, lift, other_lift, other_lg, x, reps):
    """One K5f/K5Lf case: both checkouts' tape kernel held to this tree's
    plain tape forward (marginals and tapes identical), then timed in
    turns. Returns the case's JSON record."""
    layered = kernel == "K5Lf"
    if layered:
        tape_k, plain, it = lg.layered_tape_cuda, lg.layered_tape_forward, 10
    else:
        tape_k, plain, it = lg.flooding_tape_cuda, lg.flooding_tape_forward, 20
    other_k = getattr(other_lg, tape_k.__name__)
    out = {}
    new = kept(out, "this", lambda: tape_k(lift, x, it))
    old = kept(out, "other", lambda: other_k(other_lift, x, it))
    want = plain(lift, x, it)
    for name, call in (("this", new), ("other", old)):
        call()
        for got, ref in zip(out.pop(name), want):
            identical(got, ref, f"{name} {kernel} {shape}")
    del want
    (o1, o2), (n1, n2) = in_turns(reps, old, new)
    out.clear()
    layout = lift.k3_layout(None) if layered else lift.k1_layout()
    return {"kernel": kernel, "shape": f"{shape}, "
            f"{'layered-10' if layered else 'BP-20'} boxplus",
            "other_ms": [o1, o2], "this_ms": [n1, n2],
            "threads": layout.threads, "cluster": layout.cluster,
            "smem_bytes": layout.smem_bytes}


def grad_case(kernel, shape, lift, other_lift, other_lg, x, gen, reps):
    """One K5b/K5Lb case: both checkouts' backward kernel on this tree's
    tape against the plain reverse and each other, then timed in turns.
    Returns the case's JSON record."""
    layered = kernel == "K5Lb"
    if layered:
        tape_k, back, plain = (lg.layered_tape_cuda, lg.layered_reverse_cuda,
                               lg.layered_reverse)
    else:
        tape_k, back, plain = (lg.flooding_tape_cuda,
                               lg.flooding_reverse_cuda, lg.flooding_reverse)
    # this tree's tape at BP-20 or layered-10, a standard normal dL/dmarg
    marg, *tapes = tape_k(lift, x, 10 if layered else 20)
    g = torch.randn(marg.shape, generator=gen, device="cuda")
    del marg
    other_back = getattr(other_lg, back.__name__)
    out = {}
    new = kept(out, "this", lambda: back(lift, x, *tapes, g))
    old = kept(out, "other", lambda: other_back(other_lift, x, *tapes, g))
    new()
    old()
    want = plain(lift, x, *tapes, g)
    rel = check_grads(out, want, f"{kernel} {shape}")
    del want
    between = float((out["this"] - out["other"]).abs().max())
    (o1, o2), (n1, n2) = in_turns(reps, old, new)
    layout = lift._grad_plans["k5lb" if layered else "k5b"]
    info = ({"gc_on_chip": layout.gc_on_chip} if layered else
            {"cluster": layout.cluster, "staged": layout.staged})
    out.clear()
    return {"kernel": kernel, "shape": f"{shape}, "
            f"{'layered-10' if layered else 'BP-20'} boxplus",
            "rel_err_vs_plain": rel, "max_abs_this_vs_other": between,
            "other_ms": [o1, o2], "this_ms": [n1, n2],
            "threads": layout.threads, "smem_bytes": layout.smem_bytes,
            **info}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other checkout")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--kernels", nargs="+",
                        default=["K1", "K3", "K5f", "K5Lf", "K5b", "K5Lb"],
                        help="the kernels whose cases run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare needs a CUDA device")
    other = other_package(args.parent)
    other_lg = other.lifted_grad
    libs = []
    if {"K1", "K3"} & set(args.kernels):
        libs += [other.decoding.LIFTED_BP_KERNEL,
                 other.decoding.LAYERED_BP_KERNEL, LIFTED_BP_KERNEL,
                 LAYERED_BP_KERNEL]
    if {"K5f", "K5Lf", "K5b", "K5Lb"} & set(args.kernels):
        libs += [other_lg.LIFTED_BP_GRAD_KERNEL,
                 other_lg.LAYERED_BP_GRAD_KERNEL, lg.LIFTED_BP_GRAD_KERNEL,
                 lg.LAYERED_BP_GRAD_KERNEL]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.library(), libs))
    # libs: groups of four, the other checkout's pair, then this tree's
    for i in range(0, len(libs), 4):
        for theirs, ours in zip(libs[i:i + 2], libs[i + 2:i + 4]):
            a, b = ptxas_figures(theirs), ptxas_figures(ours)
            for entry in sorted(set(a) | set(b)):
                print(json.dumps({"library": ours.name, "entry": entry,
                                  "other": a.get(entry),
                                  "this": b.get(entry)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = {}
    with torch.no_grad():
        for kernel, storage, shape in CASES:
            if kernel not in args.kernels:
                continue
            if shape not in inputs:
                k, n, nbps, batch, ebno_db = SHAPES[shape]
                enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps)
                dec = LDPC5GDecoder(enc, cn_update="boxplus",
                                    engine="lifted")
                other_lift = other.LDPC5GDecoder(
                    other.LDPC5GEncoder(k, n, num_bits_per_symbol=nbps),
                    cn_update="boxplus", engine="lifted").lifted
                inputs[shape] = (dec.lifted, other_lift,
                                 llrs(dec, batch, ebno_db, gen))
            lift, other_lift, x = inputs[shape]
            if kernel in ("K5f", "K5Lf"):
                print(json.dumps(tape_case(kernel, shape, lift, other_lift,
                                           other_lg, x, args.reps)),
                      flush=True)
                continue
            if kernel in ("K5b", "K5Lb"):
                print(json.dumps(grad_case(kernel, shape, lift, other_lift,
                                           other_lg, x, gen, args.reps)),
                      flush=True)
                continue
            if kernel == "K3":
                old, new = (
                    lambda: other.decoding.layered_bp_cuda(other_lift, x, 10,
                                                           storage),
                    lambda: layered_bp_cuda(lift, x, 10, storage))
                want = lift.decode_layered(x, 10, storage)
                layout = lift.k3_layout(storage)
                info = {"lanes": layout.lanes}
            else:
                old, new = (lambda: other.decoding.lifted_bp_cuda(
                    other_lift, x, 20), lambda: lifted_bp_cuda(lift, x, 20))
                want = lift.decode(x, 20)
                layout = lift.k1_layout()
                info = {}
            variant = "bf16" if storage is not None else "f32"
            try:
                identical(old(), want, f"other {kernel} {variant} {shape}")
            except ValueError as err:  # the other layout refuses the code
                print(f"other {kernel} {variant} {shape}: {err}")
                old = None
            identical(new(), want, f"{kernel} {variant} {shape}")
            o1 = cuda_ms(old, args.reps) if old else None
            n1 = cuda_ms(new, args.reps)
            n2 = cuda_ms(new, args.reps)
            o2 = cuda_ms(old, args.reps) if old else None
            print(json.dumps({"kernel": kernel, "variant": variant,
                              "shape": shape, "other_ms": [o1, o2],
                              "this_ms": [n1, n2],
                              "threads": layout.threads,
                              "cluster": layout.cluster, **info}),
                  flush=True)
        if "K3" in args.kernels:
            lift, _, x = inputs["n=2048 x 2000"]
            print(json.dumps({"kernel": "K3", "variant": "f32",
                              "shape": "n=2048 x 2000",
                              "ms_by_threads": k3_thread_sweep(
                                  lift, x, args.reps)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
