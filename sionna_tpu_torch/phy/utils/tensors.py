"""Shape-algebra utilities (counterpart of
``sionna_tpu/phy/utils/tensors.py``)."""

import torch

from ..config import config


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


def flatten_dims(tensor, num_dims, axis):
    """Flattens ``num_dims`` consecutive axes starting at ``axis`` into
    one axis."""
    tensor = torch.as_tensor(tensor)
    if num_dims < 2:
        raise ValueError("`num_dims` must be >= 2")
    if num_dims > tensor.dim():
        raise ValueError("`num_dims` must <= rank(`tensor`)")
    if axis < 0:
        axis += tensor.dim()
    if not 0 <= axis <= tensor.dim() - 1:
        raise ValueError("0<= `axis` <= rank(tensor)-1")
    if num_dims + axis > tensor.dim():
        raise ValueError("`num_dims`+`axis` <= rank(`tensor`)")
    return tensor.flatten(axis, axis + num_dims - 1)


def flatten_last_dims(tensor, num_dims=2):
    """Flattens the last ``num_dims`` axes."""
    tensor = torch.as_tensor(tensor)
    return flatten_dims(tensor, num_dims, tensor.dim() - num_dims)


def split_dim(tensor, shape, axis):
    """Reshapes the axis at position ``axis`` into ``shape``."""
    tensor = torch.as_tensor(tensor)
    if axis < 0:
        axis += tensor.dim()
    if not 0 <= axis <= tensor.dim() - 1:
        raise ValueError("0<= `axis` <= rank(tensor)-1")
    s = tuple(tensor.shape)
    return tensor.reshape(s[:axis] + tuple(shape) + s[axis + 1:])


def diag_part_axis(tensor, axis=0):
    """Diagonal over the axes ``axis`` and ``axis+1``, appended as the
    last axis."""
    tensor = torch.as_tensor(tensor)
    if axis < 0:
        axis += tensor.dim()
    return torch.diagonal(tensor, dim1=axis, dim2=axis + 1)


def matrix_diag_part(tensor):
    """Diagonal of the last two axes."""
    return torch.diagonal(torch.as_tensor(tensor), dim1=-2, dim2=-1)


def flatten_multi_index(indices, shape):
    """Converts multi-dimensional indices (the last axis holds the
    coordinates) into flat indices of a tensor of shape ``shape``."""
    indices = torch.as_tensor(indices)
    shape = [int(s) for s in shape]
    # the strides as Python numbers: nothing is copied to the device
    flat = indices[..., 0]
    for i, s in enumerate(shape[1:], start=1):
        flat = flat * s + indices[..., i]
    return flat


def gather_from_batched_indices(params, indices):
    """Gathers values of ``params`` (rank N) at the batched ``indices``
    [..., N], the last axis holding one index per axis of ``params``:
    a tensor of shape [...]. Indices must lie inside ``params``'s
    shape."""
    params = torch.as_tensor(params)
    flat_idx = flatten_multi_index(indices, params.shape)
    return params.reshape(-1)[flat_idx.long()]


def tensor_values_are_in_set(tensor, admissible_set):
    """`True` (a bool tensor) iff every element of ``tensor`` belongs to
    ``admissible_set``."""
    tensor = torch.as_tensor(tensor)
    admissible = torch.as_tensor(admissible_set, device=tensor.device
                                 ).reshape(-1)
    return torch.all(torch.any(tensor[..., None] == admissible, dim=-1))


def random_tensor_from_values(values, shape, dtype=None, generator=None):
    """Random tensor of ``shape`` whose entries are drawn uniformly from
    ``values``.

    It lies on the generator's device when one is given, else on that of
    ``values`` when it is a tensor, else on ``config.device``; the draw
    comes from ``generator``, else from ``config.generator`` of that
    device.
    """
    if generator is not None:
        device = generator.device
    elif isinstance(values, torch.Tensor):
        device = values.device
    else:
        device = config.device
    values = torch.as_tensor(values, dtype=dtype, device=device).reshape(-1)
    if generator is None:
        generator = config.generator(device)
    idx = torch.randint(0, values.shape[0], tuple(shape),
                        generator=generator, device=device)
    return values[idx]


def enumerate_indices(bounds, device=None):
    """All index combinations within ``bounds`` as the rows of a
    [prod(bounds), len(bounds)] int64 tensor, on ``device`` (default:
    the CPU)."""
    grids = torch.meshgrid(*[torch.arange(int(b), device=device)
                             for b in bounds], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def find_true_position(bool_tensor, side="last", axis=-1):
    """Position of the first/last `True` along ``axis``; -1 if none."""
    bt = torch.as_tensor(bool_tensor).to(torch.bool).movedim(axis, -1)
    n = bt.shape[-1]
    idx = torch.arange(n, device=bt.device)
    if side == "last":
        return torch.where(bt, idx, -1).amax(dim=-1)
    if side == "first":
        pos = torch.where(bt, idx, n).amin(dim=-1)
        return torch.where(pos == n, -1, pos)
    raise ValueError("side must be 'first' or 'last'")
