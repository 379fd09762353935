"""Polar code construction utilities.

PyTorch-port counterpart of ``sionna_tpu/phy/fec/polar/utils.py``: host
NumPy, since code construction is offline. The 5G reliability sequence
(TS 38.212 Tab. 5.3.1.2-1) is read from the JAX package's
``polar_5G.csv``, by path.
"""

import functools
import os

import numpy as np
from scipy.special import comb

__all__ = ["generate_5g_ranking", "generate_polar_transform_mat",
           "generate_rm_code", "generate_dense_polar"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
_CH_ORDER_CSV = os.path.join(_REPO_ROOT, "sionna_tpu", "phy", "fec", "polar",
                             "codes", "polar_5G.csv")


@functools.cache
def _load_ch_order():
    """The reliability table [channel rank, index] (read only)."""
    return np.genfromtxt(_CH_ORDER_CSV, delimiter=";").astype(int)


def generate_5g_ranking(k, n, sort=True):
    """Frozen and info positions of the 5G polar code of length ``n``
    with ``k`` info bits. Returns (frozen_pos, info_pos)."""
    if not isinstance(k, (int, np.integer)):
        raise TypeError("k must be integer.")
    if not isinstance(n, (int, np.integer)):
        raise TypeError("n must be integer.")
    if k < 0:
        raise ValueError("k cannot be negative.")
    if k > 1024 or n > 1024:
        raise ValueError("k and n cannot be larger than 1024.")
    if n < 32:
        raise ValueError("n must be >=32.")
    if n < k:
        raise ValueError("Invalid coderate (>1).")
    if np.log2(n) != int(np.log2(n)):
        raise ValueError("n must be a power of 2.")
    ch_order = _load_ch_order()
    # channels with index < n, ordered by reliability
    ind = np.argsort(ch_order[:, 1])
    ch_sorted = ch_order[ind][:n]
    ch_n = ch_sorted[np.argsort(ch_sorted[:, 0])]
    frozen_pos = ch_n[:n - k, 1].astype(int)
    info_pos = ch_n[n - k:, 1].astype(int)
    if sort:
        frozen_pos = np.sort(frozen_pos)
        info_pos = np.sort(info_pos)
    return frozen_pos, info_pos


def generate_polar_transform_mat(n_lift):
    """Kronecker power ``n_lift`` of [[1, 0], [1, 1]]."""
    if n_lift >= 12:
        raise ValueError("Warning: the resulting matrix is too large.")
    gm = np.array([[1, 0], [1, 1]])
    gm_l = np.array([[1]])
    for _ in range(n_lift):
        gm_l = np.kron(gm_l, gm)
    return gm_l


def generate_rm_code(r, m):
    """Reed-Muller (r, m) code as a polar code. Returns (frozen_pos,
    info_pos, n, k, d_min)."""
    if r > m:
        raise ValueError("r cannot be larger than m.")
    if r < 0 or m < 0:
        raise ValueError("r and m must be positive.")
    n = 2 ** m
    d_min = 2 ** (m - r)
    k = int(sum(comb(m, i) for i in range(r + 1)))
    w = np.array([bin(i).count("1") for i in range(n)])
    frozen_vec = w < m - r
    frozen_pos = np.arange(n)[frozen_vec]
    info_pos = np.arange(n)[~frozen_vec]
    if len(info_pos) != k:
        raise ValueError("Error: resulting k is inconsistent.")
    return frozen_pos, info_pos, n, k, d_min


def generate_dense_polar(frozen_pos, n, verbose=True):
    """Naive (dense) parity-check and generator matrix of a polar code.
    Returns (pcm, gm)."""
    frozen_pos = np.asarray(frozen_pos)
    n = int(n)
    if np.log2(n) != int(np.log2(n)):
        raise ValueError("n must be a power of 2.")
    k = n - len(frozen_pos)
    info_pos = np.setdiff1d(np.arange(n), frozen_pos)
    gm_mat = generate_polar_transform_mat(int(np.log2(n)))
    gm = gm_mat[info_pos, :]
    pcm = np.transpose(gm_mat[:, frozen_pos])
    if np.sum(np.mod(pcm @ gm.T, 2)) != 0:
        raise ArithmeticError("Non-zero syndrome for H*G'.")
    if verbose:
        print(f"Generated dense polar code matrices with k={k}, n={n}")
    return pcm, gm
