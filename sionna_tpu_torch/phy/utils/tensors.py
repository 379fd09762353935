"""Shape-algebra utilities (counterpart of
``sionna_tpu/phy/utils/tensors.py``; the slice needs these two)."""

import torch


def expand_to_rank(tensor, target_rank, axis=-1):
    """Inserts as many size-one axes as needed at ``axis`` so that the
    result has rank ``target_rank``."""
    tensor = torch.as_tensor(tensor)
    num_dims = max(target_rank - tensor.dim(), 0)
    return insert_dims(tensor, num_dims, axis)


def insert_dims(tensor, num_dims, axis=-1):
    """Inserts ``num_dims`` size-one axes at position ``axis``."""
    tensor = torch.as_tensor(tensor)
    if num_dims < 0:
        raise ValueError("`num_dims` must be nonnegative.")
    rank = tensor.dim()
    if not -(rank + 1) <= axis <= rank:
        raise ValueError("`axis` is out of range `[-(D+1), D]`)")
    if axis < 0:
        axis += rank + 1
    shape = tuple(tensor.shape)
    return tensor.reshape(shape[:axis] + (1,) * num_dims + shape[axis:])
