"""Apply a frequency-domain channel (counterpart of
``sionna_tpu/phy/channel/apply_ofdm_channel.py``)."""

import torch

from ..block import Block
from ..utils.tensors import expand_to_rank
from .awgn import AWGN


class ApplyOFDMChannel(Block):
    """y = sum_tx,txa h * x (+ noise).

    x: [batch, num_tx, num_tx_ant, num_ofdm_symbols, fft_size]
    h_freq: [batch, num_rx, num_rx_ant, num_tx, num_tx_ant,
             num_ofdm_symbols, fft_size]
    -> y: [batch, num_rx, num_rx_ant, num_ofdm_symbols, fft_size]
    """

    def __init__(self, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._awgn = AWGN(precision=self.precision, device=device)

    def forward(self, x, h_freq, no=None, generator=None):
        x = torch.as_tensor(x).to(self.cdtype)
        h_freq = torch.as_tensor(h_freq).to(self.cdtype)
        x = expand_to_rank(x, h_freq.dim(), axis=1)
        y = torch.sum(h_freq * x, dim=(3, 4))
        if no is not None:
            y = self._awgn(y, no, generator=generator)
        return y
