"""OFDM modulator (counterpart of ``sionna_tpu/phy/ofdm/modulator.py``):
IFFT and cyclic prefix, one length for all symbols or one per symbol."""

import numpy as np
import torch

from ..block import Block
from ..signal.utils import ifft

__all__ = ["OFDMModulator"]


class OFDMModulator(Block):
    """Computes the time-domain OFDM signal with cyclic prefix.

    Input [..., num_ofdm_symbols, fft_size] -> time signal
    [..., num_ofdm_symbols*(fft_size+cp)] (with per-symbol CPs,
    [..., num_ofdm_symbols*fft_size + sum(cp)]).
    """

    def __init__(self, cyclic_prefix_length=0, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self.cyclic_prefix_length = cyclic_prefix_length

    @property
    def cyclic_prefix_length(self):
        return self._cyclic_prefix_length

    @cyclic_prefix_length.setter
    def cyclic_prefix_length(self, value):
        value = np.asarray(value, int)
        if not np.all(value >= 0):
            raise ValueError("`cyclic_prefix_length` must be nonnegative.")
        if value.ndim > 1:
            raise ValueError(
                "`cyclic_prefix_length` must be of rank 0 or 1")
        self._cyclic_prefix_length = value

    def forward(self, inputs):
        x = torch.as_tensor(inputs).to(self.cdtype)
        num_ofdm_symbols, fft_size = x.shape[-2:]
        cp = self._cyclic_prefix_length
        if not np.all(cp <= fft_size):
            raise ValueError(
                "`cyclic_prefix_length` cannot be larger than `fft_size`.")

        # shift the DC subcarrier to the first position, IFFT
        x_time = ifft(torch.fft.ifftshift(x, dim=-1),
                      precision=self.precision)

        if cp.ndim == 1:
            if cp.shape[0] != num_ofdm_symbols:
                raise ValueError("`cyclic_prefix_length` must be of "
                                 "size [num_ofdm_symbols]")
            # per-symbol CP: one gather from the flattened symbols
            ind = []
            for s in range(num_ofdm_symbols):
                base = s * fft_size
                ind.append(base + np.arange(fft_size - cp[s], fft_size))
                ind.append(base + np.arange(fft_size))
            ind = torch.as_tensor(np.concatenate(ind), device=x.device)
            flat = x_time.reshape(x_time.shape[:-2] + (-1,))
            return flat[..., ind]
        cpl = int(cp)
        x_time = torch.cat([x_time[..., fft_size - cpl:], x_time], dim=-1)
        return x_time.reshape(x_time.shape[:-2] + (-1,))
