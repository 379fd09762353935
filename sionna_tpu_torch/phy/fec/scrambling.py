"""Scrambling blocks.

PyTorch counterpart of ``sionna_tpu/phy/fec/scrambling.py``. The 5G Gold
sequence (TS 38.211 Sec. 5.2.1) is generated on the host with NumPy, as
in the JAX package, and cached per length; scrambling is one XOR
(binary) or sign flip (LLRs) on the input's device.

``Scrambler``'s random sequences come from a ``torch.Generator`` seeded
with the block's integer seed; they are not the JAX package's
``jax.random`` draws, which the port cannot reproduce, but they are a
pure function of the seed and the device's generator, so a
:class:`Descrambler` undoes them.
"""

import numpy as np
import torch

from ..block import Block
from ..config import config

__all__ = ["Scrambler", "TB5GScrambler", "Descrambler",
           "generate_prng_seq"]


def generate_prng_seq(length, c_init):
    """Length-31 Gold sequence c(n) per TS 38.211 Sec. 5.2.1, as a
    NumPy f32 array of ``length`` bits."""
    nc = 1600
    n = int(length)
    total = n + nc + 31
    x1 = np.zeros(total, np.int8)
    x2 = np.zeros(total, np.int8)
    x1[0] = 1
    c_init = int(c_init)
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    # the recursions in chunks of 28 bits: x[i + 31] reads x[i..i + 3],
    # all of them set before the chunk of i starts
    for j in range(0, total - 31, 28):
        e = min(j + 28, total - 31)
        x1[j + 31:e + 31] = x1[j + 3:e + 3] ^ x1[j:e]
        x2[j + 31:e + 31] = (x2[j + 3:e + 3] ^ x2[j + 2:e + 2]
                             ^ x2[j + 1:e + 1] ^ x2[j:e])
    return ((x1[nc:nc + n] + x2[nc:nc + n]) % 2).astype(np.float32)


def _apply(x, seq, binary):
    """``x`` XOR ``seq`` for bits, a sign flip where ``seq`` is 1 for
    LLRs."""
    if binary:
        return x + seq - 2 * x * seq
    return x * (1 - 2 * seq)


class Scrambler(Block):
    """Randomly flips bits (binary=True) or signs (binary=False) of the
    input with a pseudo-random sequence.

    The sequence is drawn from a ``torch.Generator`` seeded with ``seed``
    (given at construction, drawn from ``config.np_rng`` when None, or
    given at the call). With ``keep_state=False`` each call takes the
    next seed, ``seed + 0x9E3779B9 * call``. An explicit ``sequence``
    overrides the random draw.
    """

    def __init__(self, seed=None, keep_batch_constant=False, sequence=None,
                 binary=True, keep_state=True, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if seed is not None and not isinstance(seed, int):
            raise TypeError("seed must be int.")
        if not isinstance(binary, bool):
            raise TypeError("binary must be bool.")
        self._keep_batch_constant = bool(keep_batch_constant)
        self._binary = binary
        self._keep_state = bool(keep_state)
        self._seed = seed if seed is not None else int(
            config.np_rng.integers(0, 2**31 - 1))
        self._call_count = 0
        self._sequence = None
        if sequence is not None:
            self._sequence = np.asarray(sequence, self.np_rdtype)

    @property
    def seed(self):
        return self._seed

    @property
    def keep_state(self):
        return self._keep_state

    @property
    def sequence(self):
        return self._sequence

    def _sequence_for(self, shape, seed, device):
        if self._keep_batch_constant:
            shape = (1,) + tuple(shape[1:])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % 2**64)
        return torch.randint(0, 2, tuple(shape), generator=gen,
                             device=device, dtype=self.rdtype)

    def forward(self, x, seed=None, binary=None):
        x = torch.as_tensor(x).to(self.rdtype)
        if binary is None:
            binary = self._binary
        if self._sequence is not None:
            seq = torch.as_tensor(self._sequence, device=x.device)
        else:
            if seed is not None:
                s = int(seed)
            elif self._keep_state:
                s = self._seed
            else:
                self._call_count += 1
                s = self._seed + 0x9E3779B9 * self._call_count
            seq = self._sequence_for(x.shape, s, x.device)
        return _apply(x, seq, binary)


class TB5GScrambler(Block):
    """5G NR PUSCH/PDSCH scrambler (TS 38.211 Sec. 6.3.1.1 / 7.3.1.1).

    If ``n_rnti``/``n_id`` are lists, the second-to-last axis must hold
    ``len(n_rnti)`` independent streams.
    """

    def __init__(self, n_rnti=1, n_id=1, binary=True, channel_type="PUSCH",
                 codeword_index=0, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(binary, bool):
            raise TypeError("binary must be bool.")
        self._binary = binary
        if channel_type not in ("PDSCH", "PUSCH"):
            raise TypeError("Unsupported channel_type.")
        if codeword_index not in (0, 1):
            raise ValueError("codeword_index must be 0 or 1.")
        if isinstance(n_rnti, (list, tuple)):
            if not isinstance(n_id, (list, tuple)) or \
                    len(n_rnti) != len(n_id):
                raise ValueError("n_rnti and n_id must have same length.")
            self._multi_stream = True
        else:
            n_rnti, n_id = [n_rnti], [n_id]
            self._multi_stream = False
        for nr, ni in zip(n_rnti, n_id):
            if nr not in range(2**16):
                raise ValueError("n_rnti must be in [0, 65535].")
            if ni not in range(1024):
                raise ValueError("n_id must be in [0, 1023].")
        self._n_rnti = [int(v) for v in n_rnti]
        self._n_id = [int(v) for v in n_id]
        # TS 38.211: c_init = n_rnti * 2^15 + q * 2^14 + n_id
        q = codeword_index if channel_type == "PDSCH" else 0
        self._c_init = [nr * 2**15 + q * 2**14 + ni
                        for nr, ni in zip(self._n_rnti, self._n_id)]
        self._seq_cache = {}

    @property
    def keep_state(self):
        return True

    def _sequences(self, n, device):
        """[streams, n] sequences on ``device``."""
        if (n, device) not in self._seq_cache:
            self._seq_cache[(n, device)] = torch.as_tensor(np.stack(
                [generate_prng_seq(n, ci) for ci in self._c_init]),
                device=device).to(self.rdtype)
        return self._seq_cache[(n, device)]

    def forward(self, x, /, *, binary=None):
        x = torch.as_tensor(x).to(self.rdtype)
        if binary is None:
            binary = self._binary
        seqs = self._sequences(x.shape[-1], x.device)
        if self._multi_stream:
            if x.shape[-2] != len(self._c_init):
                raise ValueError(
                    "Second-to-last axis must equal number of streams.")
            seq = seqs  # broadcasts over the leading dimensions
        else:
            seq = seqs[0]
        return _apply(x, seq, binary)


class Descrambler(Block):
    """Descrambler for an associated scrambler."""

    def __init__(self, scrambler, binary=True, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(scrambler, (Scrambler, TB5GScrambler)):
            raise TypeError("scrambler must be an instance of Scrambler.")
        self._scrambler = scrambler
        self._binary = bool(binary)
        if isinstance(scrambler, Scrambler) and not scrambler.keep_state:
            raise ValueError("descrambling requires keep_state=True or an "
                             "explicit seed per call")

    @property
    def scrambler(self):
        return self._scrambler

    def forward(self, x, /, *, seed=None):
        if isinstance(self._scrambler, TB5GScrambler):
            return self._scrambler(x, binary=self._binary)
        return self._scrambler(x, seed=seed, binary=self._binary)
