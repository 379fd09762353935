"""Interleaver blocks (counterpart of ``sionna_tpu/phy/fec/interleaving.py``;
the slice ports the row-column interleaver and its deinterleaver).

The permutation is computed once per sequence length on the host and
applied as one gather along the interleaved axis.
"""

import numpy as np
import torch

from ..block import Block

__all__ = ["RowColumnInterleaver", "Deinterleaver"]


class RowColumnInterleaver(Block):
    """Interleaves by writing row-wise into a matrix with ``row_depth``
    columns and reading column-wise (filler positions removed)."""

    def __init__(self, row_depth, axis=-1, inverse=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(row_depth, int):
            raise TypeError("row_depth must be int")
        self._row_depth = row_depth
        self._axis = axis
        self._inverse = bool(inverse)
        self._perm_cache = {}
        self._index_cache = {}

    @property
    def axis(self):
        return self._axis

    @property
    def row_depth(self):
        return self._row_depth

    @property
    def keep_state(self):
        return True

    def _perms(self, n_seq):
        if n_seq not in self._perm_cache:
            n = int(np.ceil(n_seq / self._row_depth) * self._row_depth)
            ind = np.arange(n).reshape(n // self._row_depth, -1).T.reshape(-1)
            perm = ind[ind < n_seq]
            self._perm_cache[n_seq] = (perm, np.argsort(perm))
        return self._perm_cache[n_seq]

    @property
    def perm_seq(self):
        if self._perm_cache:
            return next(iter(self._perm_cache.values()))[0]
        return None

    @property
    def perm_seq_inv(self):
        if self._perm_cache:
            return next(iter(self._perm_cache.values()))[1]
        return None

    def forward(self, x, inverse=None):
        x = torch.as_tensor(x)
        n_seq = x.shape[self._axis]
        inverse = self._inverse if inverse is None else inverse
        key = (n_seq, bool(inverse), x.device)
        if key not in self._index_cache:
            perm, perm_inv = self._perms(n_seq)
            self._index_cache[key] = torch.as_tensor(
                perm_inv if inverse else perm, device=x.device)
        return torch.index_select(x, self._axis, self._index_cache[key])


class Deinterleaver(Block):
    """Inverse of an associated interleaver."""

    def __init__(self, interleaver, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(interleaver, RowColumnInterleaver):
            raise TypeError("interleaver is not a valid interleaver type.")
        self._interleaver = interleaver

    @property
    def interleaver(self):
        return self._interleaver

    def forward(self, x):
        return self._interleaver(x, inverse=True)
