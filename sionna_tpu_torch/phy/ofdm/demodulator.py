"""OFDM demodulator (counterpart of
``sionna_tpu/phy/ofdm/demodulator.py``): cyclic-prefix removal, FFT and
the subcarrier phase compensation of the channel's ``l_min`` timing
offset."""

import numpy as np
import torch

from ..block import Block
from ..constants import PI
from ..signal.utils import fft

__all__ = ["OFDMDemodulator"]


class OFDMDemodulator(Block):
    """Computes the frequency-domain resource grid from a time-domain
    waveform.

    Input [..., num_ofdm_symbols*(fft_size+cp)+n] ->
    [..., num_ofdm_symbols, fft_size].
    """

    def __init__(self, fft_size, l_min, cyclic_prefix_length=0,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._fft_size = int(fft_size)
        self._l_min = int(l_min)
        cyclic_prefix_length = np.asarray(cyclic_prefix_length, int)
        if not np.all(cyclic_prefix_length >= 0):
            raise ValueError("`cyclic_prefix_length` must be nonnegative.")
        self._cyclic_prefix_length = cyclic_prefix_length

        # phase compensation e^{-j 2 pi k l_min / N}
        k = np.arange(self._fft_size, dtype=np.float64)
        tmp = -2 * PI * self._l_min / self._fft_size * k
        self.register_buffer("_phase_compensation", torch.as_tensor(
            np.exp(1j * tmp).astype(self.np_cdtype), device=self.device),
            persistent=False)

    @property
    def fft_size(self):
        return self._fft_size

    @property
    def l_min(self):
        return self._l_min

    @property
    def cyclic_prefix_length(self):
        return self._cyclic_prefix_length

    def forward(self, inputs):
        x = torch.as_tensor(inputs).to(self.cdtype)
        cp = self._cyclic_prefix_length
        if cp.ndim == 0:
            cpl = int(cp)
            sym_len = self._fft_size + cpl
            num_ofdm_symbols = x.shape[-1] // sym_len
            x = x[..., :num_ofdm_symbols * sym_len]
            x = x.reshape(x.shape[:-1] + (num_ofdm_symbols, sym_len))
            x = x[..., cpl:]
        else:
            # per-symbol CP lengths: gather the FFT windows
            ind = []
            base = 0
            for s in range(cp.shape[0]):
                base += int(cp[s])
                ind.append(base + np.arange(self._fft_size))
                base += self._fft_size
            x = x[..., torch.as_tensor(np.stack(ind), device=x.device)]

        x = fft(x, precision=self.precision)
        x = x * self._phase_compensation.to(x.device)
        return torch.fft.fftshift(x, dim=-1)
