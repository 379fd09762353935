"""FP32 operation counts of the CUDA math functions the LDPC kernels call,
read from the SASS that ``nvcc`` makes of them on this machine, and the
operation count of one boxplus edge-lane update built from them, and of
one update of the gradient's reverse: the operation side of the kernels'
bounds in ``chip_smoke.py``.

Each function is compiled alone into a probe kernel (``y[i] = f(x[i])``)
for ``sm_90a``, and ``cuobjdump -sass`` lists its instructions. Only the
path that a call with the kernels' arguments executes is counted: from
the probe's entry to its ``EXIT``, every conditional branch taken or not
as the probe says (``PROBES``), and no ``CALL`` (the slow-path
subroutines of division). A predicated instruction on the path counts,
since it is issued either way. Each FP32 arithmetic instruction (``F*``
opcodes but the integer ``FLO``, and ``MUFU``) is one instruction, and
one operation except ``FFMA``, which is two: the operations are held
against the 67 TFLOP/s FP32 rate, the instructions against the issue
rate of one per lane and clock.

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); builds into
``build/sionna_tpu_torch/``. Run: ``python -m
sionna_tpu_torch.tools.sass_ops``.
"""

import json
import os
import re
import shutil
import subprocess

from .._build import BUILD_DIR, _nvcc

# probe: (expression, whether its conditional branches are taken). The
# kernels divide (1 + ext) / (1 - ext) with ext in [0, 1 - 1e-7], never
# the slow path's operands, so division's branch around its slow-path
# call is taken. log1pf branches around the block for negative, infinite
# and NaN arguments: taken for log1pf(ext), not for log1pf(-ext). tanhf
# and logf have no branch: both of tanhf's ranges are computed and one
# selected.
PROBES = {
    "tanhf": ("tanhf(x[i])", True),
    "log1pf(+)": ("log1pf(x[i])", True),
    "log1pf(-)": ("log1pf(x[i])", False),
    "logf": ("logf(x[i])", True),
    "fdiv": ("x[i] / x[i + 1]", True),
}
# FP32 operations of one edge lane and iteration besides those functions,
# as ldpc_lifted_bp.cu writes them, none of them an FMA. CN: |m|, / 2,
# the sign compare and select (2), the mask's select, the backward
# product, the forward product, fwd * bwd, the clamp at 1 - 1e-7, -ext
# (log1p form) or 1 + ext and 1 - ext (ratio form), the magnitude
# subtraction (log1p form), the clamp at the clip and three multiplies by
# sign_tot, the sign and the mask; VN: the add into the marginal, the
# subtraction of the edge's own message and the clamp (2). The same count
# in both forms.
OTHER_OPS = 19
# FP32 operations (= instructions) that one edge lane and iteration of
# min-sum needs, counted from the function, not from ldpc_lifted_bp.cu's
# code for it (the SASS probe has no function to isolate: they are
# inline comparisons and selects), none of them an FMA. CN: |m| (1), the
# running minimum (1), the second minimum as min(min2, max(min1, |m|))
# (2), the extrinsic's compare and select (2), the clamp at the clip (1)
# and one application of the extrinsic sign (1); VN: the add into the
# marginal, the subtraction of the edge's own message and the clamp (4).
# Left out as the implementation's, not the function's: the padding
# lanes' select and 0/1 mask multiply, the sign's compare and select
# (sign-bit work), the separate multiply by sign_tot, and the count of
# minima. The offset's subtraction and clamp are skipped at offset 0
# (min-sum).
MINSUM_OPS = 12
# FP32 operations of one boxplus edge-lane update of the gradient's
# reverse (K5b, K5Lb) besides one forward update (``ops_per_update``,
# whose tanh, products and magnitude it reuses) and one division (the
# ``fdiv`` probe), counted from the function (XLA's autodiff of the JAX
# package's lifted decode), not from ldpc_cn_grad.cuh's code for it, with
# the constants 2 of 2 atanh and 1/2 of tanh(|m|/2) folded. CN: the c2v
# gradient times the edge's sign (1), the clip's mask (compare and
# select, 2), d 2atanh(x)/dx = 2 / (1 - x^2) as an FFMA and the division
# and the multiply by the gradient (3), the mask of the clamp at 1 - 1e-7
# (2), the reverse of the prefix and suffix products (a multiply and an
# FFMA for the edge's input, and for each of the two chains, 9), dt/dm =
# (1 - t^2) sign(m) / 2 as an FFMA, a multiply and the sign (4): 21. VN,
# flooding: the v2c clip's mask (|x| and compare, 2), its multiply, the
# sum over the column and the edge's own term out of it (3): 5; layered:
# the posterior's gradient into the edge's, the edge's into the
# posterior's and the old c2v's (3).
ADJOINT_OPS = {"flooding": 26, "layered": 24}
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                   r"\s*([^;]*);")
_FP = re.compile(r"^((?!FLO)F[A-Z0-9]+|MUFU)(\.|$)")


def _cuobjdump():
    for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump",
              os.path.join(os.path.dirname(_nvcc()), "cuobjdump")):
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("cuobjdump not found")


def path_ops(insns, taken):
    """(FP32 instructions, FP32 operations) on the path from address 0 to
    the first unpredicated ``EXIT`` of one function's instructions
    ``insns`` ({address: (predicate, opcode, operands)}), every
    conditional branch ``taken`` or not. Raises on a ``CALL`` on the
    path."""
    n_insn = n_ops = 0
    addr = 0
    for _ in range(len(insns) + 1):
        pred, op, args = insns[addr]
        name = op.split(".")[0]
        if name == "EXIT" and not pred:
            return n_insn, n_ops
        if name == "CALL":
            raise RuntimeError(f"a call on the counted path at {addr:#x}")
        if name == "BRA" and (taken or not pred):
            addr = int(args.split()[-1], 16)
            continue
        if _FP.match(op):
            n_insn += 1
            n_ops += 2 if name == "FFMA" else 1
        addr = min(a for a in insns if a > addr)
    raise RuntimeError("no EXIT on the counted path")


def function_ops():
    """{probe: (FP32 instructions, FP32 operations) on its path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "sass_probe.cu"
    names = {p: f"probe_{i}" for i, p in enumerate(PROBES)}
    src.write_text("".join(
        f'extern "C" __global__ void {names[p]}(const float* x, '
        f"float* y) {{ int i = threadIdx.x; y[i] = {expr}; }}\n"
        for p, (expr, _) in PROBES.items()))
    cubin = BUILD_DIR / "sass_probe.cubin"
    subprocess.run([_nvcc(), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(cubin),
                    str(src)], check=True, capture_output=True, text=True)
    funcs = parse_sass(subprocess.run(
        [_cuobjdump(), "-sass", str(cubin)], check=True, capture_output=True,
        text=True).stdout)
    return {p: path_ops(funcs[names[p]], taken)
            for p, (_, taken) in PROBES.items()}


def parse_sass(sass):
    """{function: {address: (predicate, opcode, operands)}} of
    ``cuobjdump -sass`` output."""
    funcs, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = funcs.setdefault(m.group(1), {})
            continue
        m = _INSN.match(line)
        if m and current is not None:
            current[int(m.group(1), 16)] = (m.group(2), m.group(3),
                                            m.group(4))
    return funcs


def ops_per_update(counts):
    """{form: (FP32 instructions, FP32 operations) of one boxplus
    edge-lane update}: tanhf, then log1pf(ext) - log1pf(-ext) (log1p
    form) or logf((1 + ext) / (1 - ext)) (ratio form), and
    ``OTHER_OPS``."""
    forms = {"log1p": ("tanhf", "log1pf(+)", "log1pf(-)"),
             "ratio": ("tanhf", "logf", "fdiv")}
    return {form: tuple(sum(counts[f][i] for f in funcs) + OTHER_OPS
                        for i in (0, 1))
            for form, funcs in forms.items()}


def backward_ops_per_update(counts, layered):
    """FP32 operations of one boxplus (log1p form) edge-lane update of the
    gradient kernels' reverse: a forward update, a division and
    ``ADJOINT_OPS``."""
    return (ops_per_update(counts)["log1p"][1] + counts["fdiv"][1]
            + ADJOINT_OPS["layered" if layered else "flooding"])


def main():
    counts = function_ops()
    print(json.dumps({"function_ops": counts,
                      "ops_per_update": ops_per_update(counts),
                      "backward_ops_per_update": {
                          sched: backward_ops_per_update(
                              counts, sched == "layered")
                          for sched in ADJOINT_OPS}}))


if __name__ == "__main__":
    main()
