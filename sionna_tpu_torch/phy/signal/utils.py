"""Signal utilities: convolution, normalized (I)DFT, empirical PSD and
ACLR (counterpart of ``sionna_tpu/phy/signal/utils.py``).

A complex convolution is four real ``conv1d`` calls, as the JAX package
makes four real convolutions of it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..config import config, dtypes

__all__ = ["convolve", "fft", "ifft", "empirical_psd", "empirical_aclr"]


def _dtypes(precision):
    if precision is None:
        return config.rdtype, config.cdtype
    return (dtypes[precision]["torch"]["rdtype"],
            dtypes[precision]["torch"]["cdtype"])


def _conv1d_real(x, ker):
    """Real 1D convolution (the kernel flipped), "full" output length
    N+K-1. x: [B, N], ker: [K]."""
    k = ker.shape[0]
    out = F.conv1d(x[:, None, :], ker.flip(0)[None, None, :],
                   padding=k - 1)
    return out[:, 0, :]


def convolve(inp, ker, padding="full", axis=-1, precision=None):
    """Convolves ``inp`` with ``ker`` along ``axis``.

    padding: "full" (N+K-1) | "same" (N, centered on (K-1)//2) |
    "valid" (N-K+1).
    """
    padding = padding.lower()
    if padding not in ("valid", "same", "full"):
        raise ValueError("Invalid padding method")
    rdtype, cdtype = _dtypes(precision)
    inp = torch.as_tensor(inp)
    ker = torch.as_tensor(ker, device=inp.device)
    complex_out = inp.is_complex() or ker.is_complex()
    inp = inp.to(cdtype if inp.is_complex() else rdtype)
    ker = ker.to(cdtype if ker.is_complex() else rdtype)

    inp = torch.movedim(inp, axis, -1)
    batch_shape = inp.shape[:-1]
    n = inp.shape[-1]
    k = ker.shape[0]
    x = inp.reshape(-1, n)

    if complex_out:
        xr, xi = (x.real, x.imag) if x.is_complex() \
            else (x, torch.zeros_like(x))
        kr, ki = (ker.real, ker.imag) if ker.is_complex() \
            else (ker, torch.zeros_like(ker))
        rr = _conv1d_real(xr, kr)
        ii = _conv1d_real(xi, ki)
        ri = _conv1d_real(xr, ki)
        ir = _conv1d_real(xi, kr)
        out = torch.complex(rr - ii, ri + ir).to(cdtype)
    else:
        out = _conv1d_real(x, ker)

    # crop the "full" output per padding mode
    if padding == "same":
        start = (k - 1) // 2
        out = out[:, start:start + n]
    elif padding == "valid":
        out = out[:, k - 1:k - 1 + max(n - k + 1, 0)]

    out = out.reshape(batch_shape + (out.shape[-1],))
    return torch.movedim(out, -1, axis)


def fft(tensor, axis=-1, precision=None):
    """Normalized DFT: scaled by 1/sqrt(N)."""
    cdtype = _dtypes(precision)[1]
    tensor = torch.as_tensor(tensor).to(cdtype)
    n = tensor.shape[axis]
    return torch.fft.fft(tensor, dim=axis) * (1 / np.sqrt(n))


def ifft(tensor, axis=-1, precision=None):
    """Normalized IDFT: scaled by sqrt(N)."""
    cdtype = _dtypes(precision)[1]
    tensor = torch.as_tensor(tensor).to(cdtype)
    n = tensor.shape[axis]
    return torch.fft.ifft(tensor, dim=axis) * np.sqrt(n)


def empirical_psd(x, show=True, oversampling=1.0, ylim=(-30, 3),
                  precision=None):
    """Empirical power spectral density by the periodogram. Returns
    (freqs, psd)."""
    rdtype = _dtypes(precision)[0]
    x = torch.as_tensor(x)
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[-1]
    spec = torch.fft.fftshift(torch.fft.fft(x, dim=-1), dim=-1)
    psd = (torch.mean(torch.abs(spec) ** 2, dim=0) / n).to(rdtype)
    freqs = (torch.fft.fftshift(torch.fft.fftfreq(n, device=x.device,
                                                  dtype=torch.float64))
             * oversampling).to(rdtype)
    if show:
        import matplotlib.pyplot as plt
        plt.figure()
        plt.plot(freqs.cpu().numpy(),
                 10 * np.log10(np.maximum(psd.cpu().numpy(), 1e-12)))
        plt.title("Power Spectral Density")
        plt.xlabel("Normalized Frequency")
        plt.ylabel(r"$\mathbb{E}\left[|X(f)|^2\right]$ (dB)")
        plt.ylim(ylim)
        plt.grid(True, which="both")
    return freqs, psd


def empirical_aclr(x, oversampling=1.0, f_min=-0.5, f_max=0.5,
                   precision=None):
    """Empirical adjacent channel leakage ratio: out-of-band power over
    in-band power, the band being [f_min, f_max]."""
    freqs, psd = empirical_psd(x, oversampling=oversampling, show=False,
                               precision=precision)
    in_band = (freqs >= f_min) & (freqs <= f_max)
    p_in = torch.sum(torch.where(in_band, psd, torch.zeros_like(psd)))
    p_out = torch.sum(torch.where(in_band, torch.zeros_like(psd), psd))
    return p_out / p_in
