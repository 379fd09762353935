"""k3.roofline_pct: K3 (``csrc/ldpc_layered_bp.cu``, ``layered_bp_kernel``,
layered BP) against its roofline: the least time of a launch (its bytes at the
card's HBM bandwidth or its operations at its FP32 rate, whichever is
larger, both counted from the algorithm in ``reference/work.py``) over
the device time of the traced launches."""


def read(run):
    return run.roofline("k3", "layered_bp_kernel")
