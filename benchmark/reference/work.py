"""Work of one LDPC decoder launch, counted from the algorithm's update
formulas (not from any implementation's instructions), for the kernels'
roofline shares.

Bytes: each input read once and each output written once. The decoder's
input is the channel LLRs and its output the marginals, both float32
[B, num_vns]: ``8 * B * num_vns`` bytes. A plan, a layout or message
state that an implementation keeps is not counted.

Operations, FP32, each arithmetic operation, comparison-select and
elementary function counting 1 (so a fused multiply-add is 2, as the
peak counts it). On an edge of the pruned lifted graph, per iteration:

check node, boxplus by the tanh rule, c2v = sign * min(2 atanh(prod of
the others' tanh(|v2c| / 2), capped below 1), llr_max):
  |v2c| 1, halving 1, tanh(x) = 1 - 2 / (1 + exp(2x)) 5 (multiply, exp,
  add, divide, subtract), its sign 1, the prefix and the suffix product
  and their product 3, the cap 1, 2 atanh(e) = log((1 + e) / (1 - e)) 4
  (add, subtract, divide, log), the clip at llr_max 1, the row's sign
  product and applying both signs 3: 20.
variable node, flooding (v2c = clip(llr + sum c2v - c2v)): the sum 1,
  the extrinsic difference 1, the clip 2: 4; and per variable node the
  marginal's clip 2.
variable node, layered (v2c = posterior - old c2v; posterior += new -
  old c2v): 3.

So a flooding iteration costs 24 E + 2 N and a layered one 23 E, for E
edges and N variable nodes of one codeword; no early stop, so every
launch does ``num_iter`` iterations on all B codewords.
"""

CN_OPS = 20
VN_OPS_FLOODING = 4
VN_MARGINAL_OPS = 2
VN_OPS_LAYERED = 3


def lifted_bp_work(code, batch, num_iter, layered):
    """{"flops", "bytes"} of one decode of ``batch`` codewords of
    ``code`` (a ``ldpc5g.Code``), ``num_iter`` iterations."""
    e, n = code.num_edges, code.num_vns
    if layered:
        per_iter = (CN_OPS + VN_OPS_LAYERED) * e
    else:
        per_iter = (CN_OPS + VN_OPS_FLOODING) * e + VN_MARGINAL_OPS * n
    return {"flops": float(num_iter * batch * per_iter),
            "bytes": float(8 * batch * n)}
