"""Channel utility functions (counterpart of
``sionna_tpu/phy/channel/utils.py``; the port needs the OFDM frequency
response of a channel impulse response)."""

import torch

from ..config import config, dtypes
from ..constants import PI

__all__ = ["subcarrier_frequencies", "cir_to_ofdm_channel"]


def subcarrier_frequencies(num_subcarriers, subcarrier_spacing,
                           precision=None, device=None):
    """Baseband subcarrier frequencies, DC-centered."""
    rdtype = config.rdtype if precision is None \
        else dtypes[precision]["torch"]["rdtype"]
    start = -(num_subcarriers // 2)
    limit = num_subcarriers // 2 + (num_subcarriers % 2)
    freqs = torch.arange(start, limit, dtype=rdtype, device=device)
    return freqs * subcarrier_spacing


def cir_to_ofdm_channel(frequencies, a, tau, normalize=False):
    """Channel frequency response h(f) = sum_m a_m exp(-j2 pi f tau_m).

    a: [b, rx, rxa, tx, txa, paths, T]; tau: [b, rx, tx, paths] or
    [b, rx, rxa, tx, txa, paths]. Returns
    [b, rx, rxa, tx, txa, T, fft_size]. The sum over paths is a batched
    matrix product [T, paths] x [paths, fft_size].
    """
    a = torch.as_tensor(a)
    tau = torch.as_tensor(tau)
    if tau.dim() == 4:
        tau = tau[:, :, None, :, None, :]
    freqs = torch.as_tensor(frequencies, dtype=tau.dtype, device=tau.device)
    phase = 2 * PI * freqs * tau[..., None]  # [..., paths, fft_size]
    e = torch.complex(torch.cos(phase), -torch.sin(phase)).to(a.dtype)
    h_f = torch.matmul(a.transpose(-1, -2), e)  # [..., T, fft_size]

    if normalize:
        c = torch.mean(torch.abs(h_f) ** 2, dim=(2, 4, 5, 6), keepdim=True)
        c = torch.sqrt(c)
        h_f = torch.where(c == 0, torch.zeros_like(h_f),
                          h_f / torch.where(c == 0, torch.ones_like(c), c))
    return h_f
