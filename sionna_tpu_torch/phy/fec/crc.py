"""CRC encoding and decoding (3GPP TS 38.212 Sec. 5.1 polynomials).

PyTorch counterpart of ``sionna_tpu/phy/fec/crc.py``. The parity bits are
one GF(2) matrix product ``u @ P mod 2``: the k x crc_length parity
matrix ``P`` is built on the host (cached per k) and the product runs as
an f32 ``matmul`` followed by ``remainder(2)``, exact for k < 2^24.
"""

import numpy as np
import torch

from ..block import Block

__all__ = ["CRCEncoder", "CRCDecoder"]

_CRC_COEFFS = {
    "CRC24A": [24, 23, 18, 17, 14, 11, 10, 7, 6, 5, 4, 3, 1, 0],
    "CRC24B": [24, 23, 6, 5, 1, 0],
    "CRC24C": [24, 23, 21, 20, 17, 15, 13, 12, 8, 4, 2, 1, 0],
    "CRC16": [16, 12, 5, 0],
    "CRC11": [11, 10, 9, 5, 0],
    "CRC6": [6, 5, 0],
}


def _crc_parity_matrix(k, crc_degree):
    """[k, d] GF(2) matrix P with CRC(u) = u @ P mod 2.

    Row i is x^(d + k - 1 - i) mod g(x), by iterating the polynomial
    shift on the host.
    """
    coeffs = _CRC_COEFFS[crc_degree]
    d = coeffs[0]
    # g(x) taps below degree d, bit j the coefficient of x^j
    g_low = sum(1 << c for c in coeffs[1:])
    mask = (1 << d) - 1
    # r = x^d mod g = g_low (x^d = g(x) - its low part in GF(2)); the
    # remainders as Python ints (a loop of shifts, fast for k ~ 1e5)
    r = g_low
    rems = [r]
    for _ in range(k - 1):
        # r <- r * x mod g
        r = ((r << 1) & mask) ^ (g_low if r >> (d - 1) else 0)
        rems.append(r)
    rems = np.array(rems[::-1], np.int64)  # row i: x^(d + k - 1 - i)
    rows = ((rems[:, None] >> np.arange(d)) & 1).astype(np.uint8)
    # 3GPP appends the remainder MSB first (the coefficient of x^{d-1}
    # first); the rows hold the coefficients of x^0..x^{d-1}
    return rows[:, ::-1]


class CRCEncoder(Block):
    """Appends a CRC to the last axis of the input bit tensor.

    Input [..., k] -> output [..., k + crc_length].
    """

    def __init__(self, crc_degree, *, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if crc_degree not in _CRC_COEFFS:
            raise ValueError(f"Invalid crc_degree: {crc_degree}")
        self._crc_degree = crc_degree
        self._crc_length = _CRC_COEFFS[crc_degree][0]
        self._pmats = {}  # k -> host parity matrix
        self._pmat_tensors = {}  # (k, device, dtype) -> tensor
        self._k = None
        self._n = None

    @property
    def crc_degree(self):
        return self._crc_degree

    @property
    def crc_length(self):
        return self._crc_length

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    def _get_pmat(self, k):
        """The host [k, crc_length] f32 parity matrix."""
        if k not in self._pmats:
            self._pmats[k] = _crc_parity_matrix(
                k, self._crc_degree).astype(np.float32)
        return self._pmats[k]

    def parity(self, bits):
        """CRC parity bits [..., crc_length] of ``bits`` [..., k], in the
        dtype of ``bits`` (a floating tensor)."""
        k = bits.shape[-1]
        key = (k, bits.device, bits.dtype)
        if key not in self._pmat_tensors:
            self._pmat_tensors[key] = torch.as_tensor(
                self._get_pmat(k), device=bits.device).to(bits.dtype)
        return torch.remainder(torch.matmul(bits, self._pmat_tensors[key]),
                               2)

    def numpy_structure(self):
        """The parity matrix of the last length encoded, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        if self._k is None:
            return {}
        return {"parity_matrix": self._get_pmat(self._k)}

    def forward(self, bits):
        bits = torch.as_tensor(bits).to(self.rdtype)
        k = bits.shape[-1]
        self._k = k
        self._n = k + self._crc_length
        return torch.cat([bits, self.parity(bits)], dim=-1)


class CRCDecoder(Block):
    """Verifies and removes the CRC of the associated
    :class:`CRCEncoder`.

    Input [..., k + crc_length] -> (bits [..., k], crc_valid [..., 1]
    bool).
    """

    def __init__(self, crc_encoder, *, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(crc_encoder, CRCEncoder):
            raise TypeError("crc_encoder must be a CRCEncoder")
        self._encoder = crc_encoder

    @property
    def encoder(self):
        return self._encoder

    def forward(self, bits):
        bits = torch.as_tensor(bits).to(self.rdtype)
        k = bits.shape[-1] - self._encoder.crc_length
        u = bits[..., :k]
        parity = self._encoder.parity(u)
        crc_valid = torch.all(parity == bits[..., k:], dim=-1, keepdim=True)
        return u, crc_valid
