"""Times the lifted BP kernels of this tree against those of another
checkout (e.g. the parent commit's), in turns on one card.

K3 (layered-10, boxplus): f32 and bf16 c2v storage at the flagship code
n=12288 at batch 2048 and at BG1 with Z=384, n=16896 and n=25344 (the
largest 5G code) at batch 2048, and f32 at the coded-AWGN code n=2048 at
batch 2000. K1 (BP-20, f32,
boxplus) at the flagship shape. The other checkout's package is imported
beside this one (as ``sionna_tpu_torch_other``; the package's imports
are relative) and runs through its own ``layered_bp_cuda`` and
``lifted_bp_cuda``, which build its kernels from its own sources into its
own ``build/``. For each case it checks that both kernels give this
tree's plain decode's marginals exactly, then times them in the order
other, this, this, other (CUDA events, one warm-up, ``--reps`` calls
each); a code the other checkout's layout refuses is timed on this
tree's kernel alone. Prints one JSON line per case (with this tree's
layout of the kernel). Then it times this tree's K3 f32 at the
coded-AWGN shape with 1-5 threads per lane, in the order 1..5, 5..1
(the layout's choice at that code is one), and prints the card.

Run on the card from the repository root, with the other checkout's
package and LDPC tables unpacked under ``build/`` (gitignored), e.g.
``git archive <commit> sionna_tpu_torch sionna_tpu/phy/fec/ldpc/codes |
tar -x -C build/parent``:
``python -m sionna_tpu_torch.tools.kernel_compare --parent build/parent``.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
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
         ("K1", None, "n=12288 x 2048")]
OTHER = "sionna_tpu_torch_other"


def other_package(root):
    """The LDPC decoding module of the checkout at ``root``, imported as
    ``sionna_tpu_torch_other.phy.fec.ldpc``."""
    init = Path(root).resolve() / "sionna_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="root of the other checkout")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare needs a CUDA device")
    other = other_package(args.parent)
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda k: k.library(), (
            other.decoding.LIFTED_BP_KERNEL, other.decoding.LAYERED_BP_KERNEL,
            LIFTED_BP_KERNEL, LAYERED_BP_KERNEL)))
    gen = torch.Generator(device="cuda").manual_seed(4)
    inputs = {}
    with torch.no_grad():
        for kernel, storage, shape in CASES:
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
        lift, _, x = inputs["n=2048 x 2000"]
        print(json.dumps({"kernel": "K3", "variant": "f32",
                          "shape": "n=2048 x 2000",
                          "ms_by_threads": k3_thread_sweep(lift, x,
                                                           args.reps)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
