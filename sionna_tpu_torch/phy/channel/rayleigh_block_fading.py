"""Rayleigh block fading (counterpart of
``sionna_tpu/phy/channel/rayleigh_block_fading.py``)."""

import torch

from ..config import config
from .channel_model import ChannelModel


class RayleighBlockFading(ChannelModel):
    """i.i.d. Rayleigh fading: one zero-delay path, constant over the
    time steps of a block.

    Returns ``a`` [batch, num_rx, num_rx_ant, num_tx, num_tx_ant, 1,
    num_time_steps] (a broadcast view of one draw per block) and ``tau``
    zeros [batch, num_rx, num_tx, 1]. The draw comes from ``generator``
    when given (on its device), else from ``config.generator`` of
    ``device`` (default: the ``device`` given here, else
    ``config.device``).
    """

    def __init__(self, num_rx, num_rx_ant, num_tx, num_tx_ant,
                 precision=None, device=None):
        super().__init__(precision=precision)
        self.num_rx = int(num_rx)
        self.num_rx_ant = int(num_rx_ant)
        self.num_tx = int(num_tx)
        self.num_tx_ant = int(num_tx_ant)
        self._device = config.device if device is None \
            else torch.device(device)

    def __call__(self, batch_size, num_time_steps, sampling_frequency=None,
                 generator=None, device=None):
        if generator is not None:
            dev = generator.device
        else:
            dev = self._device if device is None else torch.device(device)
            generator = config.generator(dev)
        shape = (int(batch_size), self.num_rx, self.num_rx_ant,
                 self.num_tx, self.num_tx_ant, 1, 1)
        std = 0.5 ** 0.5
        hr = torch.randn(shape, generator=generator, dtype=self.rdtype,
                         device=dev)
        hi = torch.randn(shape, generator=generator, dtype=self.rdtype,
                         device=dev)
        h = torch.complex(std * hr, std * hi)
        a = h.expand(shape[:-1] + (int(num_time_steps),))
        tau = torch.zeros((int(batch_size), self.num_rx, self.num_tx, 1),
                          dtype=self.rdtype, device=dev)
        return a, tau
