"""Plain OFDM link pieces for the benchmark's reference, in PyTorch, in
the precision a caller asks for (complex128 for the reference, with a
rounding hook for the lower-precision control).

Written from the definitions the configurations state: Gray QAM of TS
38.211 5.1, the row-column interleaver, the resource grid of upstream
Sionna (data resource elements in symbol-then-subcarrier order, pilots
elsewhere), Kronecker pilots (QPSK from NumPy's ``default_rng(seed)``,
one sequence per stream on interleaved subcarriers), the frequency
response of a channel impulse response normalized to unit mean energy
per resource grid, LS estimation with nearest-pilot interpolation by
Manhattan distance (first pilot in row-major order on a tie), the SISO
LMMSE equalizer (x = y / h, effective noise (N0 + error variance) /
|h|^2), and exact APP demapping by log-sum-exp over the constellation
(LLR = log P(b=1) / P(b=0)).
"""

import numpy as np
import torch

from .compare import identity


def qam_points(num_bits):
    """[2^m] complex128 Gray QAM points of unit mean energy; the label of
    point i is the binary form of i (MSB first), its even bits on the
    real axis and its odd bits on the imaginary axis (TS 38.211 5.1)."""
    m = num_bits // 2

    def pam(bits):
        # 38.211's recursion: (1-2 b0) (2^(m-1) - pam(b1..))
        if len(bits) == 1:
            return 1 - 2 * bits[0]
        return (1 - 2 * bits[0]) * (2 ** (len(bits) - 1) - pam(bits[1:]))

    pts = []
    for i in range(2 ** num_bits):
        b = [(i >> (num_bits - 1 - j)) & 1 for j in range(num_bits)]
        pts.append(pam(b[0::2]) + 1j * pam(b[1::2]))
    pts = np.asarray(pts, np.complex128)
    energy = 2 * np.mean(np.arange(1, 2 ** m, 2) ** 2)
    return pts / np.sqrt(energy)


def bit_labels(num_bits):
    """[2^m, m] bits of each point label, MSB first."""
    i = np.arange(2 ** num_bits)[:, None]
    return (i >> (num_bits - 1 - np.arange(num_bits))) & 1


def map_bits(bits, num_bits, cdtype):
    """[..., n] bits -> [..., n / m] symbols."""
    pts = torch.as_tensor(qam_points(num_bits), device=bits.device)
    w = torch.as_tensor(2 ** np.arange(num_bits - 1, -1, -1),
                        device=bits.device)
    idx = (bits.reshape(bits.shape[:-1] + (-1, num_bits)).to(torch.int64)
           * w).sum(-1)
    return pts[idx].to(cdtype)


def row_column_perm(n, depth):
    """Output position i reads input position perm[i]: written row by
    row into rows of ``depth``, read column by column."""
    rows = -(-n // depth)
    ind = np.arange(rows * depth).reshape(rows, depth).T.reshape(-1)
    return ind[ind < n]


def kronecker_pilots(num_streams, num_sym, num_sc, pilot_symbols, seed=0):
    """(mask [S, T, F] bool, pilots [S, P] complex128): QPSK pilots drawn
    from ``default_rng(seed)`` per stream, stream s on subcarriers s, s+S,
    ..., normalized to unit mean energy per stream; P pilots per stream
    in row-major order of the mask."""
    mask = np.zeros((num_streams, num_sym, num_sc), bool)
    mask[:, pilot_symbols, :] = True
    rng = np.random.default_rng(seed)
    per = num_sc // num_streams
    pil = np.zeros((num_streams, len(pilot_symbols), num_sc), np.complex128)
    for s in range(num_streams):
        b = rng.integers(0, 2, (len(pilot_symbols), per, 2))
        p = ((1 - 2 * b[..., 0]) + 1j * (1 - 2 * b[..., 1])) / np.sqrt(2)
        pil[s, :, s::num_streams] = p
    pil = pil.reshape(num_streams, -1)
    energy = np.mean(np.abs(pil) ** 2, axis=-1, keepdims=True)
    return mask, pil / np.sqrt(energy)


def grid_positions(mask):
    """(data, pilot) flat indices of one stream's [T, F] grid, row-major."""
    flat = mask.reshape(-1)
    return np.nonzero(~flat)[0], np.nonzero(flat)[0]


def nearest_pilot(mask):
    """[T * F] index into the pilots (row-major) of the nearest pilot of
    each resource element by Manhattan distance, the first on a tie."""
    t, f = mask.shape
    ip, jp = np.nonzero(mask)
    ti, fi = np.meshgrid(np.arange(t), np.arange(f), indexing="ij")
    d = (np.abs(ti.reshape(-1, 1) - ip[None, :])
         + np.abs(fi.reshape(-1, 1) - jp[None, :]))
    return np.argmin(d, axis=1)


def subcarrier_frequencies(fft_size, spacing):
    """DC-centred subcarrier frequencies in Hz (float64 NumPy)."""
    return np.arange(-(fft_size // 2), fft_size - fft_size // 2) * spacing


def ofdm_channel(a, tau, freqs, normalize=True, q=identity):
    """Frequency response [b, rx, rxa, tx, txa, T, F] of path gains ``a``
    [b, rx, rxa, tx, txa, paths, T] with delays ``tau`` [b, rx, tx,
    paths] or [b, rx, rxa, tx, txa, paths], in ``a``'s dtype: h = sum_p
    a_p exp(-j 2 pi f tau_p), divided by the root of its mean energy over
    the receive and transmit antennas, symbols and subcarriers of each
    link. ``q`` rounds each intermediate result (the control's lower
    precision)."""
    f = torch.as_tensor(freqs, dtype=tau.dtype, device=a.device)
    if tau.dim() == 4:
        tau = tau[:, :, None, :, None, :]
    ph = q(-2 * np.pi * tau[..., None] * q(f))           # [.., paths, F]
    e = q(torch.exp(1j * ph.to(a.dtype)))
    h = q(torch.einsum("...pt,...pf->...tf", q(a), e))
    if normalize:
        c = q(torch.mean(torch.abs(h) ** 2, dim=(2, 4, 5, 6), keepdim=True))
        h = q(h / q(torch.sqrt(c)))
    return h


def ls_nn_lmmse_siso(y, pilots, data_pos, pilot_pos, nearest, no,
                     q=identity):
    """SISO receiver of one stream: y [B, T * F] received grid, pilots
    [P]. LS at the pilots, nearest-pilot interpolation, LMMSE
    equalization. Returns (x_hat, no_eff) at the data positions."""
    h_ls = q(y[:, pilot_pos] / pilots)
    err_var = q(no / q(torch.abs(pilots) ** 2))
    h_hat = h_ls[:, nearest][:, data_pos]
    ev = err_var[nearest][data_pos]
    x_hat = q(y[:, data_pos] / h_hat)
    no_eff = q(q(no + ev) / q(torch.abs(h_hat) ** 2))
    return x_hat, no_eff


def app_demap(x_hat, no_eff, num_bits, q=identity):
    """Exact APP LLRs [..., N * m] (logit convention) of symbols ``x_hat``
    [..., N] with noise variances ``no_eff`` [..., N]."""
    pts = torch.as_tensor(qam_points(num_bits), device=x_hat.device)
    lab = torch.as_tensor(bit_labels(num_bits), device=x_hat.device) == 1
    d2 = q(torch.abs(q(x_hat[..., None] - q(pts.to(x_hat.dtype)))) ** 2)
    logit = q(-d2 / no_eff[..., None])                   # [..., N, 2^m]
    ninf = torch.tensor(-float("inf"), dtype=logit.dtype,
                        device=logit.device)
    l1 = torch.where(lab.T, logit[..., None, :], ninf)   # [..., N, m, 2^m]
    l0 = torch.where(lab.T, ninf, logit[..., None, :])
    llr = q(q(torch.logsumexp(l1, -1)) - q(torch.logsumexp(l0, -1)))
    return llr.reshape(llr.shape[:-2] + (-1,))
