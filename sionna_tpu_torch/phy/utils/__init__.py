"""Utilities (counterpart of ``sionna_tpu.phy.utils``)."""

from .tensors import (expand_to_rank, insert_dims, flatten_dims,
                      flatten_last_dims, split_dim, diag_part_axis,
                      matrix_diag_part, flatten_multi_index,
                      gather_from_batched_indices, tensor_values_are_in_set,
                      random_tensor_from_values, enumerate_indices,
                      find_true_position)
from .metrics import (compute_ber, compute_ser, compute_bler, count_errors,
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
from .linalg import inv_cholesky, matrix_pinv
