"""Times the flooding kernel K1 of this tree against the K1 of another
checkout (the parent commit's, whose message state lived in device
memory), in turns on one card, with K3 beside them.

For each shape (the flagship code n=12288 at batch 2048, the coded-AWGN
code n=2048 at batch 2000, and BG1 at Z=384, n=16896 at batch 2048,
which this K1 runs in its cluster layout; BP-20 boxplus) and each K1
variant (f32, bf16 storage and ratio form at the flagship shape, f32 at
the others) it checks that both kernels give the plain decode's
marginals exactly, then times them in the order other, this, this,
other (CUDA events, one warm-up, ``--reps`` calls each). It also times
K3 (layered-10, f32) at the flagship shape. Prints one JSON line per
measurement and the card.

Run on the card from the repository root, with the other checkout
unpacked under ``build/`` (gitignored), e.g.
``git archive <commit> | tar -x -C build/parent``:
``python -m sionna_tpu_torch.tools.k1_compare --parent build/parent``.
"""

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from .._build import CudaKernel
from ..phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from ..phy.fec.ldpc.decoding import (LAYERED_BP_KERNEL, LIFTED_BP_KERNEL,
                                     layered_bp_cuda, lifted_bp_cuda)
from ..phy.utils import ebnodb2no
from .ldpc_tune import KERNEL_VARIANTS, cuda_ms

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (k, n, bits per symbol, batch, Eb/N0 dB)
SHAPES = {"n=12288 x 2048": (6144, 12288, None, 2048, 2.5),
          "n=2048 x 2000": (1024, 2048, 4, 2000, 3.0),
          "n=16896 x 2048": (8448, 16896, None, 2048, 2.5)}
VARIANTS = {label: knobs for label, (schedule, knobs)
            in KERNEL_VARIANTS.items() if schedule == "flooding"}


def parent_kernel(root):
    """The other checkout's K1, with the C interface it had while its
    message state lived in device memory (scratch buffers as
    arguments)."""
    return CudaKernel(
        name="ldpc_lifted_bp_parent",
        source=str(Path(root).resolve() / "sionna_tpu_torch" / "csrc"
                   / "ldpc_lifted_bp.cu"),
        replaces=LIFTED_BP_KERNEL.replaces,
        functions={
            "sionna_ldpc_lifted_bp": ([_P] * 11 + [_I] * 6 + [_F, _F]
                                      + [_I] * 3 + [_P], _I),
            "sionna_cuda_error_string": ([_I], ctypes.c_char_p),
        })


def parent_call(kern, lifted, llr_int, num_iter, storage_dtype=None,
                atanh_form="log1p"):
    """One launch of the other checkout's K1 on the current stream."""
    z, n_cols = lifted._z, lifted._n_col_blocks
    batch, n_edges = llr_int.shape[0], len(lifted._edges)
    bf16 = storage_dtype is not None
    llr_p = F.pad(llr_int, (0, n_cols * z - lifted._num_vns)).contiguous()
    out = torch.empty_like(llr_p)
    v2c = torch.empty((batch, n_edges, z), device=llr_int.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    c2v = torch.empty((batch, n_edges, z), device=llr_int.device) \
        if bf16 else None
    tables = (lifted.masks, lifted.edge_col, lifted.edge_shift,
              lifted.row_ptr, lifted.row_edge_ids, lifted.col_ptr,
              lifted.col_edge_ids)
    err = kern.library().sionna_ldpc_lifted_bp(
        llr_p.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
        v2c.data_ptr(), None if c2v is None else c2v.data_ptr(), batch,
        lifted._n_row_blocks, n_cols, n_edges, z, num_iter,
        lifted._llr_max, lifted._offset,
        0 if lifted._cn_mode == "boxplus" else 1, int(bf16),
        int(atanh_form == "ratio"), torch.cuda.current_stream().cuda_stream)
    kern.check(err)
    return out[:, :lifted._num_vns]


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
        raise SystemExit("k1_compare needs a CUDA device")
    old = parent_kernel(args.parent)
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda k: k.library(),
                      (old, LIFTED_BP_KERNEL, LAYERED_BP_KERNEL)))
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for shape, (k, n, nbps, batch, ebno_db) in SHAPES.items():
            enc = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps)
            dec = LDPC5GDecoder(enc, cn_update="boxplus", engine="lifted")
            lift = dec.lifted
            x = llrs(dec, batch, ebno_db, gen)
            layout = lift.k1_layout()
            for variant, kw in VARIANTS.items():
                if shape != "n=12288 x 2048" and variant != "K1 f32":
                    continue
                want = lift.decode(x, 20, **kw)
                identical(parent_call(old, lift, x, 20, **kw), want,
                          f"other K1 {variant} {shape}")
                identical(lifted_bp_cuda(lift, x, 20, **kw), want,
                          f"K1 {variant} {shape}")
                o1 = cuda_ms(lambda: parent_call(old, lift, x, 20, **kw),
                             args.reps)
                n1 = cuda_ms(lambda: lifted_bp_cuda(lift, x, 20, **kw),
                             args.reps)
                n2 = cuda_ms(lambda: lifted_bp_cuda(lift, x, 20, **kw),
                             args.reps)
                o2 = cuda_ms(lambda: parent_call(old, lift, x, 20, **kw),
                             args.reps)
                print(json.dumps({"kernel": "K1", "variant": variant,
                                  "shape": shape, "other_ms": [o1, o2],
                                  "this_ms": [n1, n2],
                                  "threads": layout.threads,
                                  "cluster": layout.cluster}), flush=True)
            if shape != "n=12288 x 2048":
                continue
            k3 = cuda_ms(lambda: layered_bp_cuda(lift, x, 10), args.reps)
            print(json.dumps({"kernel": "K3", "variant": "K3 layered f32",
                              "shape": shape + ", layered-10",
                              "ms": k3}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
