"""CIR dataset adapter (counterpart of
``sionna_tpu/phy/channel/cir_dataset.py``).

Wraps a Python generator of externally produced CIRs (e.g. from the ray
tracer) as a :class:`ChannelModel`. The generator yields ``(a, tau)``
for one example; a call stacks ``batch_size`` of them on the host and
moves them to the device in one copy each, ``a`` as one complex tensor.
"""

import numpy as np
import torch

from ..config import config
from .channel_model import ChannelModel


class CIRDataset(ChannelModel):
    """Channel model that replays CIRs from a generator, restarting it
    when it runs out.

    ``(a, tau)`` land on ``device`` (at call or here), else on
    ``config.device``.
    """

    def __init__(self, cir_generator, batch_size, num_rx, num_rx_ant,
                 num_tx, num_tx_ant, num_paths, num_time_steps,
                 precision=None, device=None):
        super().__init__(precision=precision)
        self._cir_generator = cir_generator
        self._batch_size = int(batch_size)
        self._num_rx = num_rx
        self._num_rx_ant = num_rx_ant
        self._num_tx = num_tx
        self._num_tx_ant = num_tx_ant
        self._num_paths = num_paths
        self._num_time_steps = num_time_steps
        self._device = config.device if device is None \
            else torch.device(device)
        self._iter = None

    @property
    def batch_size(self):
        return self._batch_size

    @batch_size.setter
    def batch_size(self, value):
        self._batch_size = int(value)

    def _next(self):
        if self._iter is None:
            self._iter = iter(self._cir_generator())
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self._cir_generator())
            return next(self._iter)

    @staticmethod
    def _host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    def __call__(self, batch_size=None, num_time_steps=None,
                 sampling_frequency=None, generator=None, device=None):
        dev = self._device if device is None else torch.device(device)
        bs = self._batch_size if batch_size is None else int(batch_size)
        examples = [self._next() for _ in range(bs)]
        a = np.stack([self._host(a) for a, _ in examples])
        tau = np.stack([self._host(tau) for _, tau in examples])
        return (torch.as_tensor(a.astype(self.np_cdtype), device=dev),
                torch.as_tensor(tau.astype(self.np_rdtype), device=dev))
