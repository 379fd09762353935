"""Utilities (counterpart of ``sionna_tpu.phy.utils``; the slice's part)."""

from .tensors import (expand_to_rank, insert_dims, flatten_dims,
                      flatten_last_dims, split_dim, flatten_multi_index,
                      gather_from_batched_indices, tensor_values_are_in_set,
                      enumerate_indices, find_true_position)
from .metrics import (compute_ber, compute_bler, count_errors,
                      count_block_errors)
from .misc import (ebnodb2no, hard_decisions, complex_normal, lin_to_db,
                   db_to_lin, watt_to_dbm, dbm_to_watt, log10, log2,
                   sample_bernoulli, to_list, dict_keys_to_int,
                   scalar_to_shaped_tensor, DeepUpdateDict, Interpolate,
                   SplineGriddataInterpolation, MCSDecoder, TransportBlock,
                   SingleLinkChannel)
from .numerics import expand_bound, bisection_method
from .sim import sim_ber
from .interop import load_numpy_state
from .profiling import Profiler
from .linalg import matrix_pinv
