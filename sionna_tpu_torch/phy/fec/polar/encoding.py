"""Polar encoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/polar/encoding.py``. The
polar transform is log2(n) butterfly stages (reshape, sum mod 2); the
info bits reach their positions, and the 5G rate matching its output
positions, by one gather each over index tensors built on the host. The
TS 38.212 rate matching, the sub-block, channel and input interleavers
and the CRC selection are host NumPy, as in the JAX package.
"""

import numbers

import numpy as np
import torch

from ...block import Block
from ..crc import CRCEncoder
from .utils import generate_5g_ranking

__all__ = ["PolarEncoder", "Polar5GEncoder"]


def polar_transform(u):
    """c = u G_N over GF(2) by butterfly stages; ``u`` [..., n] of 0/1
    floats, n a power of two."""
    shape = u.shape
    n = shape[-1]
    x = u
    half = 1
    while half < n:
        x = x.reshape(shape[:-1] + (n // (2 * half), 2, half))
        upper = torch.remainder(x[..., 0, :] + x[..., 1, :], 2)
        x = torch.stack([upper, x[..., 1, :]], dim=-2).reshape(shape)
        half *= 2
    return x


class PolarEncoder(Block):
    """Polar encoder for given frozen positions.

    Input [..., k] -> codeword [..., n] by the n = 2^m polar transform.
    """

    def __init__(self, frozen_pos, n, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(n, numbers.Number):
            raise TypeError("n must be a number.")
        n = int(n)
        frozen_pos = np.asarray(frozen_pos)
        if not np.issubdtype(frozen_pos.dtype, np.integer):
            raise TypeError("frozen_pos contains non int.")
        if len(frozen_pos) > n:
            raise ValueError("Num. of elements in frozen_pos cannot be "
                             "greater than n.")
        if np.log2(n) != int(np.log2(n)):
            raise ValueError("n must be a power of 2.")
        self._n = n
        self._frozen_pos = frozen_pos
        self._k = n - len(frozen_pos)
        self._info_pos = np.setdiff1d(np.arange(n), frozen_pos)
        # u[j] = bits[perm[j]]; frozen positions read a zero slot
        # appended at index k
        perm = np.full(n, self._k, np.int64)
        perm[self._info_pos] = np.arange(self._k)
        self.register_buffer("_scatter_perm", torch.as_tensor(
            perm, device=self.device), persistent=False)

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    @property
    def frozen_pos(self):
        return self._frozen_pos

    @property
    def info_pos(self):
        return self._info_pos

    def _encode(self, bits):
        """The polar codeword [..., n] of ``bits`` [..., k]."""
        if bits.shape[-1] != self._k:
            raise ValueError(
                f"Last input dimension must be of length {self._k}.")
        zero = bits.new_zeros(bits.shape[:-1] + (1,))
        src = torch.cat([bits, zero], dim=-1)
        return polar_transform(torch.index_select(
            src, -1, self._scatter_perm.to(bits.device)))

    def forward(self, bits):
        return self._encode(torch.as_tensor(bits).to(self.rdtype))


class Polar5GEncoder(PolarEncoder):
    """5G polar encoder: CRC attachment, (downlink) input interleaving,
    polar transform, sub-block interleaving, rate matching (puncturing,
    shortening or repetition) and (uplink) channel interleaving (TS
    38.212 Sec. 5.3.1 and 5.4.1). ``verbose`` is accepted for the
    reference's API and prints nothing."""

    def __init__(self, k, n, channel_type="uplink", verbose=False,
                 precision=None, device=None):
        if not isinstance(k, numbers.Number):
            raise TypeError("k must be a number.")
        if not isinstance(n, numbers.Number):
            raise TypeError("n must be a number.")
        k, n = int(k), int(n)
        if channel_type not in ("uplink", "downlink"):
            raise ValueError("channel_type must be uplink or downlink")
        self._channel_type = channel_type
        self._k_target = k
        self._n_target = n
        (crc_pol, n_polar, frozen_pos, idx_rate_matched,
         ind_input_int) = self._init_rate_match(k, n)
        super().__init__(frozen_pos, n_polar, precision=precision,
                         device=device)
        self.enc_crc = CRCEncoder(crc_pol, precision=precision,
                                  device=self.device)
        self._k_polar = k + self.enc_crc.crc_length
        self._n_polar = n_polar
        self._ind_rate_matching = idx_rate_matched.astype(np.int64)
        self._ind_input_int = None if ind_input_int is None \
            else ind_input_int.astype(np.int64)
        self.register_buffer("_rm_index", torch.as_tensor(
            self._ind_rate_matching, device=self.device), persistent=False)
        self.register_buffer("_iil_index", None if ind_input_int is None
                             else torch.as_tensor(self._ind_input_int,
                                                  device=self.device),
                             persistent=False)

    @property
    def k_target(self):
        return self._k_target

    @property
    def n_target(self):
        return self._n_target

    @property
    def k_polar(self):
        return self._k_polar

    @property
    def n_polar(self):
        return self._n_polar

    @property
    def k(self):
        return self._k_target

    @property
    def n(self):
        return self._n_target

    @property
    def ind_rate_matching(self):
        """Host indices: output position j carries mother-codeword bit
        ``ind_rate_matching[j]``."""
        return self._ind_rate_matching

    @property
    def ind_input_int(self):
        """Host indices of the downlink input interleaver (None on the
        uplink)."""
        return self._ind_input_int

    def numpy_structure(self):
        """The code's structure as NumPy arrays, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        out = {"frozen_pos": self._frozen_pos,
               "ind_rate_matching": self._ind_rate_matching}
        if self._ind_input_int is not None:
            out["ind_input_int"] = self._ind_input_int
        return out

    @staticmethod
    def subblock_interleaving(u):
        """Sub-block interleaving per TS 38.212 Sec. 5.4.1.1."""
        u = np.asarray(u)
        k = u.shape[-1]
        if k % 32 != 0:
            raise ValueError("length for sub-block interleaving must be a "
                             "multiple of 32.")
        perm = np.array([0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11,
                         19, 12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28,
                         27, 29, 30, 31])
        y = np.zeros_like(u)
        for m in range(k):
            i = int(np.floor(32 * m / k))
            j = int(perm[i] * k / 32 + np.mod(m, k / 32))
            y[m] = u[j]
        return y

    @staticmethod
    def channel_interleaver(c):
        """Triangular channel interleaver per TS 38.212 Sec. 5.4.1.3."""
        c = np.asarray(c)
        n = c.shape[-1]
        c_int = np.zeros_like(c)
        t = 0
        while t * (t + 1) / 2 < n:
            t += 1
        v = np.full([t, t], np.nan)
        ind_k = 0
        for i in range(t):
            for j in range(t - i):
                if ind_k < n:
                    v[i, j] = c[ind_k]
                ind_k += 1
        ind_k = 0
        for j in range(t):
            for i in range(t - j):
                if not np.isnan(v[i, j]):
                    c_int[ind_k] = v[i, j]
                    ind_k += 1
        return c_int

    @staticmethod
    def input_interleaver(c):
        """Input bit interleaver (downlink) per TS 38.212
        Tab. 5.3.1.1-1."""
        p_il_max_table = [
            0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34, 42, 45, 49,
            50, 51, 53, 54, 56, 58, 59, 61, 62, 65, 66, 67, 69, 70, 71, 72,
            76, 77, 81, 82, 83, 87, 88, 89, 91, 93, 95, 98, 101, 104, 106,
            108, 110, 111, 113, 115, 118, 119, 120, 122, 123, 126, 127, 129,
            132, 134, 138, 139, 140, 1, 3, 5, 8, 10, 15, 21, 27, 29, 32, 35,
            43, 46, 52, 55, 57, 60, 63, 68, 73, 78, 84, 90, 92, 94, 96, 99,
            102, 105, 107, 109, 112, 114, 116, 121, 124, 128, 130, 133, 135,
            141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64, 74, 79, 85, 97, 100,
            103, 117, 125, 131, 136, 142, 12, 17, 23, 37, 48, 75, 80, 86,
            137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147, 148, 149,
            150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162,
            163]
        k_il_max = 164
        c = np.asarray(c)
        k = len(c)
        if k > k_il_max:
            raise ValueError(
                "Input interleaver only defined for length of 164.")
        c_apo = np.empty(k, int)
        i = 0
        for p in p_il_max_table:
            if p >= (k_il_max - k):
                c_apo[i] = c[p - (k_il_max - k)]
                i += 1
        return c_apo

    def _init_rate_match(self, k_target, n_target):
        """Rate-matching set-up per TS 38.212. Returns (crc_pol, n_polar,
        frozen_pos, rate-matching gather indices, input interleaver
        indices or None)."""
        if n_target < k_target:
            raise ValueError("n must be larger or equal k.")
        if n_target < 18:
            raise ValueError(
                "n<18 is not supported by the 5G Polar coding scheme.")
        if k_target > 1013:
            raise ValueError("k too large - currently, no codeword "
                             "segmentation supported.")
        if n_target > 1088:
            raise ValueError("n too large - currently, no codeword "
                             "segmentation supported.")
        if self._channel_type == "uplink":
            if 12 <= k_target <= 19:
                crc_pol, k_crc = "CRC6", 6
                print("Warning: For 12<=k<=19 additional 3 parity-check "
                      "bits are defined in 38.212. They are currently not "
                      "implemented.")
            elif k_target >= 20:
                crc_pol, k_crc = "CRC11", 11
            else:
                raise ValueError(
                    "k_target<12 is not supported in 5G NR uplink.")
            n_max = 10
        else:
            if k_target > 140:
                raise ValueError("k too large for downlink configuration.")
            if n_target < 25:
                raise ValueError("n too small for downlink configuration "
                                 "with 24 bit CRC.")
            if n_target > 576:
                raise ValueError("n too large for downlink configuration.")
            crc_pol, k_crc = "CRC24C", 24
            n_max = 9
        k_polar = k_target + k_crc
        if k_polar > n_target:
            raise ValueError("k_polar + k_crc + n_pc > n_target is not "
                             "supported.")
        n_min = 5
        if (n_target <= (9 / 8) * 2 ** (np.ceil(np.log2(n_target)) - 1)
                and k_polar / n_target < 9 / 16):
            n1 = np.ceil(np.log2(n_target)) - 1
        else:
            n1 = np.ceil(np.log2(n_target))
        n2 = np.ceil(np.log2(8 * k_polar))
        n_polar = int(2 ** max(min(n1, n2, n_max), n_min))

        prefrozen_pos = []
        if n_target < n_polar:
            if k_polar / n_target <= 7 / 16:
                # puncturing
                n_int = int(32 * np.ceil((n_polar - n_target) / 32))
                int_pattern = self.subblock_interleaving(np.arange(n_int))
                for i in range(n_polar - n_target):
                    prefrozen_pos.append(int(int_pattern[i]))
                if n_target >= 3 * n_polar / 4:
                    t = int(np.ceil(3 / 4 * n_polar - n_target / 2) - 1)
                else:
                    t = int(np.ceil(9 / 16 * n_polar - n_target / 4) - 1)
                prefrozen_pos.extend(range(t))
            else:
                # shortening
                n_int = int(32 * np.ceil(n_polar / 32))
                int_pattern = self.subblock_interleaving(np.arange(n_int))
                for i in range(n_target, n_polar):
                    prefrozen_pos.append(int(int_pattern[i]))
        prefrozen_pos = np.unique(prefrozen_pos).astype(int)

        ch_ranking, _ = generate_5g_ranking(0, n_polar, sort=False)
        info_cand = np.setdiff1d(ch_ranking, prefrozen_pos,
                                 assume_unique=True)
        info_pos = np.sort([info_cand[-i - 1]
                            for i in range(k_polar)]).astype(int)
        frozen_pos = np.setdiff1d(np.arange(n_polar), info_pos,
                                  assume_unique=True)

        ind_input_int = self.input_interleaver(np.arange(k_polar)) \
            if self._channel_type == "downlink" else None

        ind_sub_int = self.subblock_interleaving(np.arange(n_polar))
        if n_target >= n_polar:
            idx_c_matched = np.arange(n_target) % n_polar
        elif k_polar / n_target <= 7 / 16:
            idx_c_matched = np.arange(n_target) + n_polar - n_target
        else:
            idx_c_matched = np.arange(n_target)
        if self._channel_type == "uplink":
            ind_channel_int = self.channel_interleaver(np.arange(n_target))
            idx_rate_matched = ind_sub_int[idx_c_matched[ind_channel_int]]
        else:
            idx_rate_matched = ind_sub_int[idx_c_matched]
        return (crc_pol, n_polar, frozen_pos, np.asarray(idx_rate_matched),
                ind_input_int)

    def forward(self, bits):
        bits = torch.as_tensor(bits).to(self.rdtype)
        if bits.shape[-1] != self._k_target:
            raise ValueError("Invalid input shape.")
        in_shape = bits.shape
        u_crc = self.enc_crc(bits.reshape(-1, self._k_target))
        if self._iil_index is not None:
            u_crc = torch.index_select(u_crc, -1,
                                       self._iil_index.to(u_crc.device))
        c = self._encode(u_crc)
        c_matched = torch.index_select(c, -1, self._rm_index.to(c.device))
        return c_matched.reshape(tuple(in_shape[:-1]) + (self._n_target,))
