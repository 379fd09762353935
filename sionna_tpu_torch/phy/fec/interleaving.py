"""Interleaver blocks (counterpart of ``sionna_tpu/phy/fec/interleaving.py``).

Every permutation is computed once per sequence length (and seed) on the
host, with NumPy as in the JAX package, and applied as one gather along
the interleaved axis.
"""

import os

import numpy as np
import torch

from ..block import Block
from ..config import config

__all__ = ["RowColumnInterleaver", "RandomInterleaver", "Deinterleaver",
           "Turbo3GPPInterleaver"]

# The 3GPP turbo interleaver's (K, f1, f2) table, read where the JAX
# package keeps it
_TURBO_COEFFS = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "sionna_tpu", "phy", "fec",
    "turbo", "coeffs", "turbo_coeffs.csv")


def _take(x, idx, axis, cache, key):
    """``x`` gathered along ``axis`` at host indices ``idx``; the index
    tensor is cached per (key, device)."""
    key = key + (x.device,)
    if key not in cache:
        cache[key] = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    return torch.index_select(x, axis, cache[key])


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
        perm, perm_inv = self._perms(n_seq)
        return _take(x, perm_inv if inverse else perm, self._axis,
                     self._index_cache, (n_seq, bool(inverse)))


class RandomInterleaver(Block):
    """Pseudo-random interleaver: the permutation is NumPy's
    ``default_rng(seed).permutation``, a pure function of the seed
    (given at construction or at the call), so it is the JAX package's
    permutation for the same seed. ``seed=None`` draws one from
    ``config.np_rng``. With ``keep_state=False`` each call takes the
    next seed, ``seed + 0x9E3779B9 * call``. ``keep_batch_constant`` is
    accepted as in the JAX package: one permutation for the whole
    batch."""

    def __init__(self, seed=None, keep_batch_constant=True, inverse=False,
                 keep_state=True, axis=-1, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if seed is not None and not isinstance(seed, int):
            raise TypeError("seed must be int.")
        self._seed = seed if seed is not None else int(
            config.np_rng.integers(0, 2**31 - 1))
        self._keep_batch_constant = bool(keep_batch_constant)
        self._inverse = bool(inverse)
        self._keep_state = bool(keep_state)
        self._axis = axis
        self._call_count = 0
        self._perm_cache = {}
        self._index_cache = {}

    @property
    def seed(self):
        return self._seed

    @property
    def axis(self):
        return self._axis

    @property
    def keep_state(self):
        return self._keep_state

    def _perms(self, n, seed):
        if (n, seed) not in self._perm_cache:
            perm = np.random.default_rng(seed).permutation(n)
            self._perm_cache[(n, seed)] = (perm, np.argsort(perm))
        return self._perm_cache[(n, seed)]

    def find_s_min(self, seed, seq_length, s_min_stop=0):
        """Spread factor S = min |pi(i) - pi(i+1)| of the permutation for
        ``seed``."""
        perm = self._perms(int(seq_length), int(seed))[0]
        return int(np.abs(np.diff(perm)).min())

    def forward(self, x, seed=None, inverse=None):
        x = torch.as_tensor(x)
        n = x.shape[self._axis]
        if seed is not None:
            s = int(seed)
        elif self._keep_state:
            s = self._seed
        else:
            self._call_count += 1
            s = self._seed + 0x9E3779B9 * self._call_count
        inverse = self._inverse if inverse is None else inverse
        perm, perm_inv = self._perms(n, s)
        return _take(x, perm_inv if inverse else perm, self._axis,
                     self._index_cache, (n, s, bool(inverse)))


class Turbo3GPPInterleaver(Block):
    """3GPP LTE turbo-code interleaver (TS 36.212): pi(i) = (f1 i + f2
    i^2) mod K with (f1, f2) from the standard's table, shortened to the
    frame size when it is not a supported K."""

    def __init__(self, inverse=False, axis=-1, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(axis, int):
            raise TypeError("axis must be int.")
        self._axis = axis
        self._inverse = bool(inverse)
        self._perm_cache = {}
        self._index_cache = {}
        table = np.genfromtxt(_TURBO_COEFFS, delimiter=",")[1:]
        # columns: idx, K, f1, f2
        self._coeffs = {int(r[1]): (int(r[2]), int(r[3])) for r in table}
        self.frame_size = None

    @property
    def axis(self):
        return self._axis

    @property
    def keep_state(self):
        return True

    def _perms(self, frame_size):
        if frame_size not in self._perm_cache:
            if frame_size > 6144:
                raise ValueError("Interleaver length must be <= 6144.")
            k = next(kk for kk in sorted(self._coeffs) if kk >= frame_size)
            f1, f2 = self._coeffs[k]
            i = np.arange(k, dtype=np.int64)
            perm_full = (f1 * i + f2 * i * i) % k
            perm = perm_full[perm_full < frame_size]
            self._perm_cache[frame_size] = (perm, np.argsort(perm))
        return self._perm_cache[frame_size]

    def numpy_structure(self):
        """The permutation of the last frame size interleaved, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        if self.frame_size is None:
            return {}
        return {"perm": self._perms(self.frame_size)[0]}

    def forward(self, x, inverse=None):
        x = torch.as_tensor(x)
        self.frame_size = x.shape[self._axis]
        inverse = self._inverse if inverse is None else inverse
        perm, perm_inv = self._perms(self.frame_size)
        return _take(x, perm_inv if inverse else perm, self._axis,
                     self._index_cache, (self.frame_size, bool(inverse)))


class Deinterleaver(Block):
    """Inverse of an associated interleaver."""

    def __init__(self, interleaver, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(interleaver, (RowColumnInterleaver,
                                        RandomInterleaver,
                                        Turbo3GPPInterleaver)):
            raise TypeError("interleaver is not a valid interleaver type.")
        self._interleaver = interleaver

    @property
    def interleaver(self):
        return self._interleaver

    def forward(self, x, seed=None):
        if isinstance(self._interleaver, RandomInterleaver):
            return self._interleaver(x, seed=seed, inverse=True)
        return self._interleaver(x, inverse=True)
