"""Utilities (counterpart of ``sionna_tpu.phy.utils``; the slice's part)."""

from .tensors import expand_to_rank, insert_dims
from .metrics import (compute_ber, compute_bler, count_errors,
                      count_block_errors)
from .misc import ebnodb2no, hard_decisions
from .sim import sim_ber
from .interop import load_numpy_state
from .profiling import Profiler
from .linalg import matrix_pinv
