"""FEC utilities.

PyTorch counterpart of ``sionna_tpu/phy/fec/utils.py``: host-side NumPy
for code algebra and I/O (GF(2) elimination, generator/parity-check
conversion, alist files, the example codes), torch for the LLR source,
the J-function and the tensor bit helpers. The example codes are read
from the JAX package's ``example_codes.npy``, by path. The EXIT-chart
plotting helpers are not ported yet.
"""

import os

import numpy as np
import torch

from ..block import Block
from ..config import config
from .ldpc.encoding import _CODES_DIR

__all__ = ["GaussianPriorSource", "llr2mi", "j_fun", "j_fun_inv",
           "get_exit_analytic", "load_parity_check_examples", "bin2int",
           "int2bin", "bin2int_torch", "int2bin_torch", "bin2int_tf",
           "int2bin_tf", "alist2mat", "load_alist", "make_systematic",
           "gm2pcm", "pcm2gm", "verify_gm_pcm", "generate_reg_ldpc",
           "int_mod_2"]

_H1, _H2, _H3 = 0.3073, 0.8935, 1.1064  # Brannstrom's J-function fit


def _as_tensor(x):
    """A tensor as is; anything else through NumPy (a Python float
    becomes float64, as in the JAX package with x64 on)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class GaussianPriorSource(Block):
    """Generates synthetic LLRs as if the all-zero codeword was
    transmitted over a Bi-AWGN channel.

    Call with (output_shape, no=None, mi=None, generator=None): the LLRs
    have mean -mu and standard deviation sqrt(2 mu), with mu = 2 / no,
    or mu = j_fun_inv(mi) when ``mi`` is given instead.
    """

    def forward(self, output_shape, no=None, mi=None, generator=None):
        shape = [int(s) for s in np.asarray(
            output_shape.cpu() if isinstance(output_shape, torch.Tensor)
            else output_shape).reshape(-1)]
        dt, dev = self.rdtype, self.device
        if no is None:
            if mi is None:
                raise ValueError("Either no or mi must be provided.")
            mi = torch.clamp(torch.as_tensor(mi, dtype=dt, device=dev),
                             1e-7, 1.)
            mu_llr = j_fun_inv(mi)
            sigma_llr = torch.sqrt(2 * mu_llr)
        else:
            no = torch.clamp(torch.as_tensor(no, dtype=dt, device=dev),
                             min=1e-7)
            sigma_llr = torch.sqrt(4 / no)
            mu_llr = sigma_llr ** 2 / 2
        if generator is None:
            generator = config.generator(dev)
        return -mu_llr + sigma_llr * torch.randn(
            shape, generator=generator, dtype=dt, device=dev)


def llr2mi(llr, s=None, reduce_dims=True):
    """Empirical mutual information of LLRs in the classic convention
    (positive for correct all-zero decisions), optionally multiplied by
    the signs ``s`` first."""
    llr = torch.as_tensor(llr)
    if s is not None:
        llr = llr * torch.as_tensor(s, dtype=llr.dtype, device=llr.device)
    mi = 1 - torch.log2(1 + torch.exp(-torch.clamp(llr, -20., 20.)))
    if reduce_dims:
        return torch.mean(mi)
    return torch.mean(mi, dim=-1)


def j_fun(mu):
    """Brannstrom's approximation of the J-function."""
    mu = torch.clamp(_as_tensor(mu), 1e-10, 1000)
    return (1 - 2 ** (-_H1 * (2 * mu) ** _H2)) ** _H3


def j_fun_inv(mi):
    """Inverse of :func:`j_fun`."""
    mi = torch.clamp(_as_tensor(mi), 1e-10, 1.)
    mu = 0.5 * ((-1 / _H1) * torch.log2(1 - mi ** (1 / _H3))) ** (1 / _H2)
    return torch.clamp(mu, max=20)


def get_exit_analytic(pcm, ebno_db):
    """Analytic EXIT curves (mi_a, mi_ev, mi_ec) of the degree
    distribution of the parity-check matrix ``pcm``, NumPy arrays."""
    pcm = np.asarray(pcm)
    n = pcm.shape[1]
    k = n - pcm.shape[0]
    coderate = k / n
    ebno = 10 ** (ebno_db / 10)
    snr = ebno * coderate
    noise_var = 1 / (2 * snr)
    sigma_llr = np.sqrt(4 / noise_var)
    mu_llr = sigma_llr ** 2 / 2

    c_max = int(np.max(np.sum(pcm, axis=1)) + 1)
    v_max = int(np.max(np.sum(pcm, axis=0)) + 1)
    c = np.histogram(np.sum(pcm, axis=1), bins=c_max, range=(0, c_max))[0]
    v = np.histogram(np.sum(pcm, axis=0), bins=v_max, range=(0, v_max))[0]
    r = np.zeros(c_max)
    for i in range(1, c_max):
        r[i] = (i - 1) * c[i]
    r = r / np.sum(r)
    l = np.zeros(v_max)
    for i in range(1, v_max):
        l[i] = (i - 1) * v[i]
    l = l / np.sum(l)
    mi_a = np.arange(0.002, 0.998, 0.001)
    mi_ec = np.zeros_like(mi_a)
    for i in range(1, c_max):
        mi_ec += r[i] * j_fun(
            (i - 1.) * j_fun_inv(1 - mi_a).numpy()).numpy()
    mi_ec = 1 - mi_ec
    mi_ev = np.zeros_like(mi_a)
    for i in range(1, v_max):
        mi_ev += l[i] * j_fun(
            mu_llr + (i - 1.) * j_fun_inv(mi_a).numpy()).numpy()
    return mi_a, mi_ev, mi_ec


def load_parity_check_examples(pcm_id, verbose=False):
    """Loads an example parity-check matrix: 0 (7,4) Hamming, 1 BCH
    (63,45), 2 BCH (127,106), 3 a regular (3,6) LDPC code of n=100, 4
    the 802.11n LDPC code of n=648. Returns (pcm, k, n, coderate)."""
    pcms = np.load(os.path.join(_CODES_DIR, "example_codes.npy"),
                   allow_pickle=True)
    pcm = np.array(pcms[pcm_id])
    n = int(pcm.shape[1])
    k = int(n - pcm.shape[0])
    coderate = k / n
    if verbose:
        print(f"\nn: {n}, k: {k}, coderate: {coderate:.3f}")
    return pcm, k, n, coderate


def bin2int(arr):
    """MSB-first binary iterable -> int."""
    out = 0
    for b in arr:
        out = (out << 1) | int(b)
    return out


def int2bin(num, length):
    """int -> MSB-first binary list of the given length."""
    if num < 0 or length < 0:
        raise ValueError("num and length must be non-negative.")
    return [int(b) for b in np.binary_repr(num, max(length, 1))
            ][-length:] if length > 0 else []


def bin2int_torch(arr, axis=-1):
    """Tensor variant of :func:`bin2int`: MSB-first bits along ``axis``
    -> int32 integers."""
    arr = torch.as_tensor(arr).to(torch.int32)
    length = arr.shape[axis]
    weights = 2 ** torch.arange(length - 1, -1, -1, dtype=torch.int32,
                                device=arr.device)
    return (torch.movedim(arr, axis, -1) * weights).sum(-1,
                                                        dtype=torch.int32)


def int2bin_torch(ints, length):
    """Tensor variant of :func:`int2bin`: integers -> MSB-first bits
    appended as a trailing axis of size ``length``."""
    ints = torch.as_tensor(ints).to(torch.int32)
    shifts = torch.arange(length - 1, -1, -1, dtype=torch.int32,
                          device=ints.device)
    return (ints[..., None] >> shifts) & 1


# the reference's TF-era names, so that imports port over unchanged
bin2int_tf = bin2int_torch
int2bin_tf = int2bin_torch


def load_alist(path):
    """Reads an .alist file into a nested list."""
    alist = []
    with open(path) as f:
        for line in f:
            alist.append([int(x) for x in line.split()])
    return alist


def alist2mat(alist, verbose=True):
    """alist (nested list) -> (pcm, k, n, coderate)."""
    n, m = alist[0]
    pcm = np.zeros((m, n), int)
    # rows 4..4+n-1: per-VN list of CN indices (1-based)
    for col, cn_list in enumerate(alist[4:4 + n]):
        for cn in cn_list:
            if cn > 0:
                pcm[cn - 1, col] = 1
    k = n - m
    coderate = k / n
    if verbose:
        print(f"Loaded alist code with n={n}, k={k}")
    return pcm, k, n, coderate


def make_systematic(mat, is_pcm=False):
    """Gaussian elimination over GF(2) to bring ``mat`` to systematic
    form. Returns (mat_sys, column_permutation)."""
    m = np.array(mat) % 2
    num_rows, num_cols = m.shape
    row = 0
    for col in range(num_cols):
        if row >= num_rows:
            break
        pivot_rows = np.where(m[row:, col] == 1)[0]
        if len(pivot_rows) == 0:
            continue
        pivot = pivot_rows[0] + row
        if pivot != row:
            m[[row, pivot]] = m[[pivot, row]]
        for r in range(num_rows):
            if r != row and m[r, col] == 1:
                m[r] = (m[r] + m[row]) % 2
        row += 1
    # move identity columns to the front (gm) or back (pcm)
    id_cols = []
    for r in range(num_rows):
        ones = np.where(m[r] == 1)[0]
        lead = None
        for c in ones:
            if np.sum(m[:, c]) == 1:
                lead = c
                break
        if lead is None:
            raise ValueError("Matrix is rank deficient.")
        id_cols.append(lead)
    other = [c for c in range(num_cols) if c not in id_cols]
    perm = np.array(other + id_cols) if is_pcm else np.array(id_cols + other)
    return m[:, perm], perm


def gm2pcm(gm, verify_results=True):
    """Generator matrix -> parity-check matrix."""
    gm = np.array(gm) % 2
    k, n = gm.shape
    gm_sys, perm = make_systematic(gm, is_pcm=False)
    p = gm_sys[:, k:]  # [k, n-k]
    pcm_sys = np.concatenate([p.T, np.eye(n - k, dtype=int)], axis=1)
    pcm = pcm_sys[:, np.argsort(perm)]
    if verify_results and not verify_gm_pcm(gm, pcm):
        raise ArithmeticError("Invalid pcm generated.")
    return pcm


def pcm2gm(pcm, verify_results=True):
    """Parity-check matrix -> generator matrix."""
    pcm = np.array(pcm) % 2
    m, n = pcm.shape
    k = n - m
    pcm_sys, perm = make_systematic(pcm, is_pcm=True)
    p = pcm_sys[:, :k]  # [m, k]
    gm_sys = np.concatenate([np.eye(k, dtype=int), p.T], axis=1)
    gm = gm_sys[:, np.argsort(perm)]
    if verify_results and not verify_gm_pcm(gm, pcm):
        raise ArithmeticError("Invalid gm generated.")
    return gm


def verify_gm_pcm(gm, pcm):
    """Checks H G^T = 0 over GF(2)."""
    s = np.mod(np.matmul(np.asarray(pcm), np.asarray(gm).T), 2)
    return np.sum(s) == 0


def generate_reg_ldpc(v, c, n, allow_flex_len=True, verbose=True):
    """Random regular (v, c) LDPC parity-check matrix, drawn from
    ``config.np_rng``. Returns (pcm, k, n, coderate)."""
    if allow_flex_len:
        # adjust n so that n*v is a multiple of c
        while (n * v) % c != 0:
            n += 1
    num_edges = n * v
    m = num_edges // c
    edges = np.repeat(np.arange(n), v)
    sockets = np.repeat(np.arange(m), c)
    perm = config.np_rng.permutation(num_edges)
    pcm = np.zeros((m, n), int)
    for e in range(num_edges):
        pcm[sockets[perm[e]], edges[e]] ^= 1
    k = n - m
    if verbose:
        print(f"Generated regular ({v},{c}) LDPC with n={n}, k={k}")
    return pcm, k, n, k / n


def int_mod_2(x):
    """Elementwise mod 2 of a float tensor of integer values."""
    return torch.remainder(torch.round(torch.as_tensor(x)), 2)
