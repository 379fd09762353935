"""Error-rate metrics (counterpart of ``sionna_tpu/phy/utils/metrics.py``).

Counts are int64 tensors on the inputs' device; nothing syncs to the
host.
"""

import torch

from ..config import dtypes


def count_errors(b, b_hat):
    """Number of positions where ``b != b_hat`` (int64 scalar)."""
    return torch.sum(torch.as_tensor(b) != torch.as_tensor(b_hat))


def count_block_errors(b, b_hat):
    """Number of rows (last axis = block) with at least one error."""
    errs = torch.any(torch.as_tensor(b) != torch.as_tensor(b_hat), dim=-1)
    return torch.sum(errs)


def compute_ber(b, b_hat, precision="double"):
    """Bit error rate between ``b`` and ``b_hat``."""
    rdtype = dtypes[precision]["torch"]["rdtype"]
    return torch.mean((torch.as_tensor(b) != torch.as_tensor(b_hat))
                      .to(rdtype))


def compute_ser(s, s_hat, precision="double"):
    """Symbol error rate between ``s`` and ``s_hat``: the share of
    differing entries, as ``compute_ber`` counts bits."""
    return compute_ber(s, s_hat, precision)


def compute_bler(b, b_hat, precision="double"):
    """Block error rate; the last axis of ``b`` is the block dim."""
    rdtype = dtypes[precision]["torch"]["rdtype"]
    errs = torch.any(torch.as_tensor(b) != torch.as_tensor(b_hat), dim=-1)
    return torch.mean(errs.to(rdtype))
