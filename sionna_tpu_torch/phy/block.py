"""Object/Block base classes.

PyTorch counterpart of ``sionna_tpu/phy/block.py``. ``Block`` is an
``nn.Module``: constant tables are registered buffers, so ``.to(device)``
moves them, and subclasses implement ``forward``. ``__call__`` keeps the
casting contract of the JAX package: floating tensors and arrays go to
the block's real dtype, complex ones to its complex dtype, and integer
or bool inputs pass through unchanged (lists, tuples and dicts are
mapped element by element).
"""

import numpy as np
import torch
from torch import nn

from .config import config, dtypes


class Object:
    """Base class for all objects: resolves the per-instance precision
    against the global config and exposes the associated dtypes."""

    def __init__(self, precision=None):
        super().__init__()
        if precision is None:
            self._precision = config.precision
        elif precision in ("single", "double"):
            self._precision = precision
        else:
            raise ValueError(f"Unknown precision: {precision}")

    @property
    def precision(self):
        """"single" | "double" : Precision of this object"""
        return self._precision

    @property
    def cdtype(self):
        """torch.dtype : Complex dtype of this object"""
        return dtypes[self.precision]["torch"]["cdtype"]

    @property
    def rdtype(self):
        """torch.dtype : Real dtype of this object"""
        return dtypes[self.precision]["torch"]["rdtype"]

    @property
    def np_cdtype(self):
        """np.dtype : NumPy complex dtype of this object"""
        return dtypes[self.precision]["np"]["cdtype"]

    @property
    def np_rdtype(self):
        """np.dtype : NumPy real dtype of this object"""
        return dtypes[self.precision]["np"]["rdtype"]


class Block(Object, nn.Module):
    """Base class for all processing blocks.

    ``device`` places the block's buffers (and the tensors it creates,
    e.g. random bits) on that device, by default ``config.device`` (the
    card); ``.to(device)`` moves them later.

    While a :class:`~sionna_tpu_torch.phy.utils.Profiler` is active, each
    call (input casts included) is a span named after the block's class
    (``type(self).__name__``), nested in the span the call was made in;
    with none active, a call costs one check of
    ``profiling.active`` more.
    """

    def __init__(self, precision=None, device=None):
        super().__init__(precision=precision)
        # Empty buffer that follows .to()/.cuda()/.cpu(): the block's
        # device even when it holds no other tensor.
        self.register_buffer(
            "_anchor", torch.empty(0, device=config.device if device is None
                                   else device), persistent=False)

    @property
    def device(self):
        """torch.device : Device of the block's buffers"""
        return self._anchor.device

    def _cast_input(self, v):
        if isinstance(v, (list, tuple)):
            return type(v)(self._cast_input(x) for x in v)
        if isinstance(v, dict):
            return {k: self._cast_input(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            v = torch.as_tensor(v, device=self.device)
        elif isinstance(v, float):
            return torch.tensor(v, dtype=self.rdtype, device=self.device)
        elif isinstance(v, complex):
            return torch.tensor(v, dtype=self.cdtype, device=self.device)
        if isinstance(v, torch.Tensor):
            if v.is_complex():
                return v.to(self.cdtype)
            if v.is_floating_point():
                return v.to(self.rdtype)
        return v

    def __call__(self, *args, **kwargs):
        tracer = profiling.active
        if tracer is not None:
            tracer.open(type(self).__name__)
        try:
            args = [self._cast_input(a) for a in args]
            kwargs = {k: self._cast_input(v) for k, v in kwargs.items()}
            return super().__call__(*args, **kwargs)
        finally:
            if tracer is not None:
                tracer.close()


# Imported last: ``phy.utils`` imports ``Block``.
from .utils import profiling  # noqa: E402 pylint: disable=C0413
