"""Universal linear encoder.

PyTorch counterpart of ``sionna_tpu/phy/fec/linear/encoding.py``.
"""

import numpy as np
import torch

from ...block import Block
from ..utils import pcm2gm

__all__ = ["LinearEncoder"]


class LinearEncoder(Block):
    """Encodes with an arbitrary binary generator matrix (or the one
    derived from a parity-check matrix with ``is_pcm=True``): one GF(2)
    matrix product, exact in floating point for integer sums.

    Input [..., k] -> [..., n].
    """

    def __init__(self, enc_mat, *, is_pcm=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        enc_mat = np.asarray(enc_mat)
        if not np.all(np.isin(enc_mat, [0, 1])):
            raise ValueError("enc_mat is not binary.")
        if enc_mat.ndim != 2:
            raise ValueError("enc_mat must be 2-D array.")
        gm = pcm2gm(enc_mat, verify_results=True) if is_pcm else enc_mat
        self._gm = gm.astype(np.float32)
        self._k, self._n = self._gm.shape
        self.register_buffer("_gm_t", torch.as_tensor(self._gm,
                                                      device=self.device),
                             persistent=False)

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    @property
    def gm(self):
        """Generator matrix [k, n] (NumPy, float32)"""
        return self._gm

    @property
    def coderate(self):
        return self._k / self._n

    def forward(self, bits):
        return torch.remainder(bits @ self._gm_t.to(bits.dtype), 2)
