"""Channel utility functions (counterpart of
``sionna_tpu/phy/channel/utils.py``; the 3GPP system-level topology
helpers are not ported yet: ROADMAP.md, queue 1 item 18)."""

import numpy as np
import torch

from ..config import config, dtypes
from ..constants import PI

__all__ = ["subcarrier_frequencies", "time_frequency_vector",
           "time_lag_discrete_time_channel", "cir_to_ofdm_channel",
           "cir_to_time_channel", "time_to_ofdm_channel", "deg_2_rad",
           "rad_2_deg", "wrap_angle_0_360", "exp_corr_mat",
           "one_ring_corr_mat"]


def _rdtype(precision):
    return config.rdtype if precision is None \
        else dtypes[precision]["torch"]["rdtype"]


def _cdtype(precision):
    return config.cdtype if precision is None \
        else dtypes[precision]["torch"]["cdtype"]


def subcarrier_frequencies(num_subcarriers, subcarrier_spacing,
                           precision=None, device=None):
    """Baseband subcarrier frequencies, DC-centered, on ``device``
    (default ``config.device``)."""
    rdtype = _rdtype(precision)
    start = -(num_subcarriers // 2)
    limit = num_subcarriers // 2 + (num_subcarriers % 2)
    freqs = torch.arange(start, limit, dtype=rdtype,
                         device=config.device if device is None else device)
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


def time_frequency_vector(num_samples, sample_duration, precision=None,
                          device=None):
    """Time and frequency vectors of ``num_samples`` samples, centered
    on 0."""
    rdtype = _rdtype(precision)
    num_samples = int(num_samples)
    n_min = num_samples // 2
    n_max = num_samples - n_min - 1
    n = torch.linspace(-n_min, n_max, num_samples, dtype=torch.float64,
                       device=device).to(rdtype)
    return n * sample_duration, n * (1 / (sample_duration * num_samples))


def time_lag_discrete_time_channel(bandwidth, maximum_delay_spread=3e-6):
    """Recommended (l_min, l_max) of the discrete-time channel's taps."""
    return -6, int(np.ceil(maximum_delay_spread * bandwidth) + 6)


def cir_to_time_channel(bandwidth, a, tau, l_min, l_max, normalize=False):
    """Discrete-time channel taps for sinc pulse shaping,
    h[l] = sum_m a_m sinc(l - W tau_m).

    a: [b, rx, rxa, tx, txa, paths, T]; tau: [b, rx, tx, paths] or
    [b, rx, rxa, tx, txa, paths]. Returns
    [b, rx, rxa, tx, txa, T, l_max - l_min + 1]. The sum over paths is a
    batched matrix product [T, paths] x [paths, taps].
    """
    a = torch.as_tensor(a)
    tau = torch.as_tensor(tau)
    if tau.dim() == 4:
        tau = tau[:, :, None, :, None, :]
    l = torch.arange(l_min, l_max + 1, dtype=tau.dtype, device=tau.device)
    sinc = torch.sinc(l - bandwidth * tau[..., None]).to(a.dtype)
    hm = torch.matmul(a.transpose(-1, -2), sinc)  # [..., T, taps]

    if normalize:
        c = torch.mean(torch.sum(torch.abs(hm) ** 2, dim=-1),
                       dim=(2, 4, 5), keepdim=True)[..., None]
        c = torch.sqrt(c).to(a.dtype)
        hm = torch.where(c == 0, torch.zeros_like(hm),
                         hm / torch.where(c == 0, torch.ones_like(c), c))
    return hm


def time_to_ofdm_channel(h_t, rg, l_min):
    """Frequency response of each OFDM symbol from discrete-time taps
    ``h_t`` [..., num_time_samples, l_max - l_min + 1]: the taps at the
    start of each symbol (after its cyclic prefix), zero-padded to
    ``fft_size`` with the negative lags wrapped, through an FFT."""
    h_t = torch.as_tensor(h_t)
    fft_size = rg.fft_size
    cp = rg.cyclic_prefix_length
    start_idx = cp + (fft_size + cp) * np.arange(rg.num_ofdm_symbols)
    start_idx = start_idx[start_idx < h_t.shape[-2]]
    h = torch.index_select(h_t, -2, torch.as_tensor(start_idx,
                                                    device=h_t.device))
    l_max = l_min + h.shape[-1] - 1
    h_pad = torch.zeros(h.shape[:-1] + (fft_size,), dtype=h.dtype,
                        device=h.device)
    # lags 0..l_max at positions 0..l_max, lags l_min..-1 wrapped to
    # fft_size + l_min .. fft_size - 1
    h_pad[..., :l_max + 1] = h[..., -l_min:]
    h_pad[..., fft_size + l_min:] = h[..., :-l_min]
    return torch.fft.fftshift(torch.fft.fft(h_pad, dim=-1), dim=-1)


def deg_2_rad(x):
    """Degrees to radians."""
    x = torch.as_tensor(x)
    return x * (PI / 180.0)


def rad_2_deg(x):
    """Radians to degrees."""
    x = torch.as_tensor(x)
    return x * (180.0 / PI)


def wrap_angle_0_360(angle):
    """Wraps angles in degrees to [0, 360)."""
    return torch.remainder(torch.as_tensor(angle), 360.)


def exp_corr_mat(a, n, precision=None, device=None):
    """Exponential correlation matrix R[i, j] = a^|i-j|, conjugated below
    the diagonal: [..., n, n] for coefficients ``a`` of shape [...]
    ([n, n] for one coefficient)."""
    cdtype = _cdtype(precision)
    a = torch.as_tensor(a, device=device).to(cdtype)
    if a.dim() == 0:
        a = a[None]
    i = torch.arange(n, device=a.device)
    d = (i[:, None] - i[None, :]).to(a.real.dtype)  # i - j
    mag = torch.abs(a)[..., None, None]
    phase = torch.angle(a)[..., None, None]
    r = (mag ** torch.abs(d)) * torch.exp(1j * (phase * d)).to(cdtype)
    # one coefficient (a scalar or a vector of one) gives one matrix
    return r[0] if a.dim() == 1 and a.shape[0] == 1 else r


def one_ring_corr_mat(phi_deg, num_ant, d_h=0.5, sigma_phi_deg=15,
                      precision=None, device=None):
    """One-ring correlation matrix of a uniform linear array (Gaussian
    local scattering, small-angle expansion): [..., num_ant, num_ant]
    for angles ``phi_deg`` of shape [...]."""
    rdtype, cdtype = _rdtype(precision), _cdtype(precision)
    phi = deg_2_rad(torch.as_tensor(phi_deg, device=device).to(rdtype))
    sigma_phi = deg_2_rad(torch.as_tensor(sigma_phi_deg).to(rdtype))
    scalar = phi.dim() == 0
    if scalar:
        phi = phi[None]
    i = torch.arange(num_ant, device=phi.device)
    d = (i[:, None] - i[None, :]).to(rdtype)  # antenna offsets
    c = 2 * PI * d_h * d
    phi_e = phi[..., None, None]
    arg = c * torch.sin(phi_e)
    exp_arg = torch.complex(
        -0.5 * (sigma_phi.to(phi.device) ** 2) * (c * torch.cos(phi_e)) ** 2,
        arg)
    r = torch.exp(exp_arg).to(cdtype)
    return r[0] if scalar else r
