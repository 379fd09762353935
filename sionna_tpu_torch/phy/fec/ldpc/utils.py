"""LDPC decoder callbacks.

PyTorch counterpart of ``sionna_tpu/phy/fec/ldpc/utils.py``. Callbacks
plug into :class:`~sionna_tpu_torch.phy.fec.ldpc.LDPCBPDecoder` through
``v2c_callbacks`` / ``c2v_callbacks`` with the signature
``cb(msg, it) -> msg``; the decoder calls them once per iteration with
the iteration number as a Python int.
"""

import numpy as np
import torch
from torch import nn

from ...block import Object
from ...config import config

__all__ = ["EXITCallback", "DecoderStatisticsCallback",
           "WeightedBPCallback"]


class EXITCallback(Object):
    """Tracks the average mutual information of the messages per
    iteration, on the host (one device sync per call)."""

    def __init__(self, num_iter):
        super().__init__()
        self._num_iter = int(num_iter)
        self.mi = np.zeros(self._num_iter)
        self._counts = np.zeros(self._num_iter)

    def __call__(self, msg, it):
        # mutual information proxy: I ~ 1 - E[log2(1 + e^{-|L|})]
        mi = torch.mean(1 - torch.log2(
            1 + torch.exp(-torch.abs(torch.clamp(msg, -20., 20.)))))
        if 0 <= it < self._num_iter:
            self.mi[it] += mi.item()
            self._counts[it] += 1
        return msg

    @property
    def mi_avg(self):
        return self.mi / np.maximum(self._counts, 1)


class DecoderStatisticsCallback(Object):
    """Tracks the mean message magnitude and the number of calls per
    iteration, on the host (one device sync per call)."""

    def __init__(self, num_iter):
        super().__init__()
        self._num_iter = int(num_iter)
        self.num_calls = np.zeros(self._num_iter)
        self.msg_mean = np.zeros(self._num_iter)

    def __call__(self, msg, it):
        if 0 <= it < self._num_iter:
            self.msg_mean[it] += torch.mean(torch.abs(msg)).item()
            self.num_calls[it] += 1
        return msg


class WeightedBPCallback(Object, nn.Module):
    """Trainable per-edge message weights for weighted BP: multiplies
    the messages [..., E] by ``weights`` [E], an ``nn.Parameter``
    (float32, initialised to ``init``), so an optimizer over the
    decoder's or this module's parameters trains them. An ``Object``
    with ``precision``, as in the JAX package.

    :meth:`with_weights` returns a callback with explicit weights, as
    the JAX package's functional form does.
    """

    def __init__(self, num_edges, init=1.0, precision=None, device=None):
        super().__init__(precision=precision)
        self.weights = nn.Parameter(torch.full(
            (int(num_edges),), float(init), dtype=torch.float32,
            device=config.device if device is None else device))

    def forward(self, msg, it):
        return msg * self.weights

    def with_weights(self, weights):
        """A callback ``cb(msg, it) = msg * weights``."""
        def cb(msg, it):
            return msg * weights
        return cb
