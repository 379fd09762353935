"""5G NR LDPC encoder per 3GPP TS 38.212, with rate matching.

PyTorch counterpart of ``sionna_tpu/phy/fec/ldpc/encoding.py``. The
encoder works in the block-circulant domain: the info word is cut into
``k_b`` blocks of ``Z`` bits, every base-graph entry is a cyclic shift
(one gather over a precomputed index map, kept as a buffer), the core
parities follow from the closed-form inverse of the double-diagonal B
submatrix, and the extension parities are shifted block sums. All sums
are on integers, then reduced mod 2.

The base graphs are read from the JAX package's CSV files, by path.
"""

import numbers
import os

import numpy as np
import scipy.sparse as sp_sparse
import torch

from ...block import Block

__all__ = ["LDPC5GEncoder"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
_CODES_DIR = os.path.join(_REPO_ROOT, "sionna_tpu", "phy", "fec", "ldpc",
                          "codes")

# lifting sets per 38.212 Tab 5.3.2-1
_LIFTING_SETS = [
    [2, 4, 8, 16, 32, 64, 128, 256],
    [3, 6, 12, 24, 48, 96, 192, 384],
    [5, 10, 20, 40, 80, 160, 320],
    [7, 14, 28, 56, 112, 224],
    [9, 18, 36, 72, 144, 288],
    [11, 22, 44, 88, 176, 352],
    [13, 26, 52, 104, 208],
    [15, 30, 60, 120, 240],
]

_BG_SHAPE = {"bg1": (46, 68), "bg2": (42, 52)}
_BG_CSV_CACHE = {}


def _load_bg_csv(bg):
    if bg not in _BG_CSV_CACHE:
        _BG_CSV_CACHE[bg] = np.genfromtxt(
            os.path.join(_CODES_DIR, f"5G_{bg}.csv"), delimiter=";")
    return _BG_CSV_CACHE[bg]


def _select_basegraph(k, r, bg=None):
    """Basegraph selection per TS 38.212 Sec. 7.2.2."""
    if bg is None:
        if k <= 292:
            bg = "bg2"
        elif k <= 3824 and r <= 0.67:
            bg = "bg2"
        elif r <= 0.25:
            bg = "bg2"
        else:
            bg = "bg1"
    elif bg not in ("bg1", "bg2"):
        raise ValueError("Basegraph must be bg1, bg2 or None.")
    if bg == "bg1" and k > 8448:
        raise ValueError("K is not supported by BG1 (too large).")
    if bg == "bg2" and k > 3840:
        raise ValueError(f"K is not supported by BG2 (too large) k={k}.")
    if bg == "bg1" and r < 1 / 3:
        raise ValueError("Only coderate > 1/3 supported for BG1.")
    if bg == "bg2" and r < 1 / 5:
        raise ValueError("Only coderate > 1/5 supported for BG2.")
    return bg


def _select_lifting(k, bg):
    """Lifting selection per TS 38.212 Sec. 5.2.2 (min Z with
    k_b*Z >= k)."""
    if bg == "bg1":
        k_b = 22
    elif k > 640:
        k_b = 10
    elif k > 560:
        k_b = 9
    elif k > 192:
        k_b = 8
    else:
        k_b = 6
    best = None
    for i_ls, s in enumerate(_LIFTING_SETS):
        for z in s:
            if k_b * z >= k and (best is None or k_b * z < best[0]):
                best = (k_b * z, z, i_ls)
    _, z, i_ls = best
    k_b = 22 if bg == "bg1" else 10
    return z, i_ls, k_b


def _load_basegraph(i_ls, bg):
    """Base matrix [m_b, n_b] with -1 for zero blocks and the shift
    value for set ``i_ls`` otherwise."""
    if not 0 <= i_ls <= 7:
        raise ValueError("i_ls out of range.")
    bm = np.full(_BG_SHAPE[bg], -1.0)
    csv = _load_bg_csv(bg)
    r_ind = 0
    for r in range(2, csv.shape[0]):
        if not np.isnan(csv[r, 0]):
            r_ind = int(csv[r, 0])
        c_ind = int(csv[r, 1])
        bm[r_ind, c_ind] = csv[r, i_ls + 2]
    return bm


def _lift_basegraph(bm, z):
    """Lifted sparse parity-check matrix (scipy CSR), for the decoder
    and for validation."""
    rows, cols = [], []
    im = np.arange(z)
    for r in range(bm.shape[0]):
        for c in range(bm.shape[1]):
            s = bm[r, c]
            if s == -1:
                continue
            rows.append(r * z + im)
            cols.append(c * z + np.mod(im + int(s), z))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    return sp_sparse.csr_matrix(
        (np.ones(len(rows)), (rows, cols)),
        shape=(z * bm.shape[0], z * bm.shape[1]))


def _entries(bm, row_range, col_range):
    """(rows, cols, shifts) of non-zero blocks within the given
    (row, col) window."""
    rs, cs, ss = [], [], []
    for r in range(*row_range):
        for c in range(*col_range):
            if bm[r, c] != -1:
                rs.append(r - row_range[0])
                cs.append(c - col_range[0])
                ss.append(int(bm[r, c]))
    return np.asarray(rs), np.asarray(cs), np.asarray(ss)


class LDPC5GEncoder(Block):
    """5G NR LDPC encoder with rate matching (TS 38.212).

    Input [..., k] binary -> output [..., n].
    """

    def __init__(self, k, n, num_bits_per_symbol=None, bg=None,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(k, numbers.Number):
            raise TypeError("k must be a number.")
        if not isinstance(n, numbers.Number):
            raise TypeError("n must be a number.")
        k = int(k)
        n = int(n)
        if k > 8448:
            raise ValueError("Unsupported code length (k too large).")
        if k < 12:
            raise ValueError("Unsupported code length (k too small).")
        if n > 316 * 384:
            raise ValueError("Unsupported code length (n too large).")
        if n < 0:
            raise ValueError("Unsupported code length (n negative).")
        self._k = k
        self._n = n
        self._coderate = k / n
        if self._coderate > 948 / 1024:
            print(f"Warning: effective coderate r>948/1024 for n={n}, "
                  f"k={k}.")
        if self._coderate > 0.95:
            raise ValueError(
                f"Unsupported coderate (r>0.95) for n={n}, k={k}.")
        if self._coderate < 1 / 5:
            raise ValueError("Unsupported coderate (r<1/5).")

        self._bg = _select_basegraph(k, self._coderate, bg)
        self._z, self._i_ls, self._k_b = _select_lifting(k, self._bg)
        self._bm = _load_basegraph(self._i_ls, self._bg)
        m_b, n_b = self._bm.shape
        self._m_b, self._n_b = m_b, n_b
        self._n_ldpc = n_b * self._z
        self._k_ldpc = self._k_b * self._z
        self._pcm = _lift_basegraph(self._bm, self._z)

        # --- block-domain encode structure -----------------------------
        z = self._z
        k_b = self._k_b
        # B submatrix shifts for the closed-form inverse
        self._pm_a = int(self._bm[0, k_b]) % z
        if self._bg == "bg1":
            self._pm_b_inv = int(-self._bm[1, k_b]) % z
        else:
            self._pm_b_inv = int(-self._bm[2, k_b]) % z
        # A: rows 0..3 x info columns; C1: rows 4.. x info columns;
        # C2: rows 4.. x core parity columns
        windows = {"A": ((0, 4), (0, k_b)),
                   "C1": ((4, m_b), (0, k_b)),
                   "C2": ((4, m_b), (k_b, k_b + 4))}
        for name, (row_range, col_range) in windows.items():
            rows, cols, shifts = _entries(self._bm, row_range, col_range)
            # gather map: idx[e, j] = col_e * z + (j + shift_e) % z
            idx = cols[:, None] * z + np.mod(
                np.arange(z)[None, :] + shifts[:, None], z)
            self.register_buffer(
                f"_g{name}", torch.as_tensor(idx, dtype=torch.int64,
                                             device=self.device),
                persistent=False)
            self.register_buffer(
                f"_r{name}", torch.as_tensor(rows, dtype=torch.int64,
                                             device=self.device),
                persistent=False)

        # output interleaver per TS 38.212 Sec. 5.4.2.2
        self._num_bits_per_symbol = num_bits_per_symbol
        if num_bits_per_symbol is not None:
            out_int, out_int_inv = self.generate_out_int(
                n, num_bits_per_symbol)
            self.register_buffer(
                "_out_int", torch.as_tensor(out_int, device=self.device),
                persistent=False)
            self.register_buffer(
                "_out_int_inv", torch.as_tensor(out_int_inv,
                                                device=self.device),
                persistent=False)
        else:
            self._out_int, self._out_int_inv = None, None

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    @property
    def coderate(self):
        return self._coderate

    @property
    def k_ldpc(self):
        return self._k_ldpc

    @property
    def n_ldpc(self):
        return self._n_ldpc

    @property
    def pcm(self):
        """scipy CSR lifted parity-check matrix"""
        return self._pcm

    @property
    def z(self):
        return self._z

    @property
    def num_bits_per_symbol(self):
        return self._num_bits_per_symbol

    @property
    def out_int(self):
        return self._out_int

    @property
    def out_int_inv(self):
        return self._out_int_inv

    def numpy_structure(self):
        """The code's structure as NumPy arrays, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {"bm": self._bm, "z": np.asarray(self._z)}

    @staticmethod
    def generate_out_int(n, num_bits_per_symbol):
        """Rate-matching output interleaver pattern (TS 38.212
        Sec. 5.4.2.2): bit i+j*Q reads from i*(n/Q)+j."""
        n = int(n)
        num_bits_per_symbol = int(num_bits_per_symbol)
        if n % num_bits_per_symbol != 0:
            raise ValueError("n must be a multiple of num_bits_per_symbol.")
        q = num_bits_per_symbol
        rows = n // q
        j = np.arange(rows)
        i = np.arange(q)
        perm_seq = (i[None, :] * rows + j[:, None]).reshape(-1)
        perm_seq_inv = np.argsort(perm_seq)
        return perm_seq, perm_seq_inv

    @staticmethod
    def _rows_sum(gather, rows, num_rows, src):
        """Per-base-row sums of shifted column blocks:
        y[r] = sum_{(r,c,s)} roll(src[c], -s), as [B, num_rows, Z]."""
        out = torch.zeros((src.shape[0], num_rows, gather.shape[1]),
                          dtype=src.dtype, device=src.device)
        return out.index_add_(1, rows, src[:, gather])

    def _encode_core(self, u_fill):
        """Full codeword [B, n_ldpc] from filler-padded integer info
        bits [B, k_ldpc] (before rate matching)."""
        z = self._z
        # ---- core parities p_a via closed-form B^{-1} ------------------
        lam = self._rows_sum(self._gA, self._rA, 4, u_fill) % 2
        lam_sum = lam.sum(dim=1) % 2
        t = torch.roll(lam_sum, -(self._pm_a + self._pm_b_inv), dims=-1)
        pa0 = torch.roll(lam_sum, -self._pm_b_inv, dims=-1)
        pa1 = (lam[:, 0] + t) % 2
        if self._bg == "bg1":
            pa2 = (t + lam[:, 2] + lam[:, 3]) % 2
        else:
            pa2 = (lam[:, 0] + lam[:, 1] + t) % 2
        pa3 = (t + lam[:, 3]) % 2
        p_a = torch.cat([pa0, pa1, pa2, pa3], dim=1)  # [B, 4Z]

        # ---- extension parities p_b ------------------------------------
        m_ext = self._m_b - 4
        p_b = (self._rows_sum(self._gC1, self._rC1, m_ext, u_fill)
               + self._rows_sum(self._gC2, self._rC2, m_ext, p_a)) % 2
        return torch.cat([u_fill, p_a, p_b.reshape(-1, m_ext * z)], dim=1)

    def forward(self, bits):
        bits = torch.as_tensor(bits)
        input_shape = bits.shape
        u = bits.reshape(-1, self._k).to(torch.int32)
        batch = u.shape[0]
        z = self._z

        u_fill = torch.cat(
            [u, torch.zeros((batch, self._k_ldpc - self._k),
                            dtype=u.dtype, device=u.device)], dim=1)
        c = self._encode_core(u_fill)

        # ---- rate matching ---------------------------------------------
        # remove filler bits, puncture the first 2Z systematic bits and
        # keep n bits
        c_no_filler = torch.cat([c[:, :self._k], c[:, self._k_ldpc:]],
                                dim=1)
        c_short = c_no_filler[:, 2 * z:2 * z + self._n]
        if self._out_int is not None:
            c_short = c_short[:, self._out_int]
        out_shape = tuple(input_shape[:-1]) + (self._n,)
        return c_short.reshape(out_shape).to(self.rdtype)
