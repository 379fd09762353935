"""Apply a discrete-time channel (counterpart of
``sionna_tpu/phy/channel/apply_time_channel.py``).

The doubly-selective convolution takes, for every output sample, the
last ``l_tot`` input samples through ``unfold`` of the zero-padded input
(the JAX package gathers them with a Toeplitz index matrix; the values
are the same) and contracts them with the taps.
"""

import torch
import torch.nn.functional as F

from ..block import Block
from .awgn import AWGN

__all__ = ["ApplyTimeChannel"]


class ApplyTimeChannel(Block):
    """y_b = sum_l h_{b,l} x_{b-l} (+ noise).

    x: [batch, num_tx, num_tx_ant, num_time_samples]
    h_time: [batch, num_rx, num_rx_ant, num_tx, num_tx_ant,
             num_time_samples + l_tot - 1, l_tot]
    -> y: [batch, num_rx, num_rx_ant, num_time_samples + l_tot - 1]
    """

    def __init__(self, num_time_samples, l_tot, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        self._awgn = AWGN(precision=self.precision, device=device)
        self._num_time_samples = int(num_time_samples)
        self._l_tot = int(l_tot)

    def forward(self, x, h_time, no=None, generator=None):
        x = torch.as_tensor(x).to(self.cdtype)
        h_time = torch.as_tensor(h_time).to(self.cdtype)
        l_tot = self._l_tot
        # x_win[..., t, l] = x[..., t - l] (0 outside [0, T)):
        # windows of the padded input, each reversed
        x_pad = F.pad(x[..., :self._num_time_samples], (l_tot - 1, l_tot - 1))
        x_win = x_pad.unfold(-1, l_tot, 1).flip(-1)
        y = torch.einsum("braxytl,bxytl->brat", h_time, x_win)
        if no is not None:
            y = self._awgn(y, no, generator=generator)
        return y
