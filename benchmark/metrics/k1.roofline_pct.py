"""k1.roofline_pct: K1 (``csrc/ldpc_lifted_bp.cu``, ``lifted_bp_kernel``,
flooding BP) against its roofline: the least time of a launch (its bytes at the
card's HBM bandwidth or its operations at its FP32 rate, whichever is
larger, both counted from the algorithm in ``reference/work.py``) over
the device time of the traced launches."""


def read(run):
    return run.roofline("k1", "lifted_bp_kernel")
