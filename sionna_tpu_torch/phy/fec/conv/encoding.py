"""Convolutional encoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/conv/encoding.py``. The
encoder runs over time as a Python loop over a [batch] integer state:
each step is one index into the flattened trellis table ``to_nodes``
(state * 2 + input bit -> next state); the output bits of every step
are read from the branch indices afterwards, in one gather. The
termination tail (zeros, or for a recursive code the input bits that
drive the register to zero) runs through the same tables.
"""

import numpy as np
import torch

from ...block import Block
from .utils import Trellis, polynomial_selector

__all__ = ["ConvEncoder"]


class ConvEncoder(Block):
    """Convolutional encoder (polynomial- or trellis-defined), optionally
    recursive systematic (``rsc``) and terminated.

    Input [..., k] -> output [..., n] with n = k / rate (+ the
    termination symbols if enabled).
    """

    def __init__(self, gen_poly=None, rate=1 / 2, constraint_length=3,
                 rsc=False, terminate=False, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if gen_poly is not None:
            if not all(isinstance(p, str) for p in gen_poly):
                raise TypeError("Each element of gen_poly must be a string.")
            if not all(len(p) == len(gen_poly[0]) for p in gen_poly):
                raise ValueError("Each polynomial must be of same length.")
            if not all(all(c in "01" for c in p) for p in gen_poly):
                raise ValueError("Each polynomial must be a string of 0/1 s.")
            self._gen_poly = gen_poly
        else:
            self._gen_poly = polynomial_selector(rate, constraint_length)
        self._rsc = bool(rsc)
        self._terminate = bool(terminate)
        self._coderate = 1 / len(self._gen_poly)
        self._trellis = Trellis(self._gen_poly, rsc=self._rsc)
        self._mu = self._trellis._mu
        self._conv_n = self._trellis.conv_n
        self._k = None
        self._n = None
        tr = self._trellis
        # branch index = state * 2 + input bit
        self.register_buffer("_to_nodes", torch.as_tensor(
            tr.to_nodes.reshape(-1), device=self.device), persistent=False)
        self.register_buffer("_op_bits", torch.as_tensor(
            tr.op_bits_by_fromnode.reshape(-1, self._conv_n),
            device=self.device), persistent=False)
        # termination: the branch of each state that the tail takes
        states = np.arange(tr.ns)
        if self._rsc:
            state_bits = (states[:, None] >> np.arange(self._mu)[::-1]) & 1
            fb = np.array([int(x) for x in self._gen_poly[0][1:]])
            tail_bit = (state_bits @ fb) % 2
        else:
            tail_bit = np.zeros(tr.ns, np.int64)
        self.register_buffer("_tail_branch", torch.as_tensor(
            states * 2 + tail_bit, device=self.device), persistent=False)

    @property
    def gen_poly(self):
        return self._gen_poly

    @property
    def coderate(self):
        if self._terminate and self._k is not None:
            return self._k / self._n
        return self._coderate

    @property
    def trellis(self):
        return self._trellis

    @property
    def terminate(self):
        return self._terminate

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    def numpy_structure(self):
        """The trellis tables, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {f"trellis.{k}": v
                for k, v in self._trellis.numpy_structure().items()}

    def forward(self, bits, /):
        bits = torch.as_tensor(bits)
        k = bits.shape[-1]
        self._k = k
        term_syms = self._mu if self._terminate else 0
        self._n = (k + term_syms) * self._conv_n
        in_shape = bits.shape
        msg = bits.reshape(-1, k).to(torch.int64)
        to_nodes = self._to_nodes.to(msg.device)
        tail = self._tail_branch.to(msg.device)
        state = msg.new_zeros(msg.shape[0])
        branches = []
        for t in range(k):
            branch = torch.add(msg[:, t], state, alpha=2)
            state = to_nodes[branch]
            branches.append(branch)
        for _ in range(term_syms):
            branch = tail[state]
            state = to_nodes[branch]
            branches.append(branch)
        cw = self._op_bits.to(msg.device)[torch.stack(branches, dim=1)]
        return cw.to(self.rdtype).reshape(tuple(in_shape[:-1]) + (self._n,))
