"""Convolutional code utilities: the trellis and the generator
polynomial tables.

PyTorch-port counterpart of ``sionna_tpu/phy/fec/conv/utils.py``: host
NumPy tables, which the encoder and decoders turn into index tensors.
"""

import numpy as np

__all__ = ["Trellis", "polynomial_selector", "int2bin", "bin2int"]


def int2bin(num, length):
    """Integer to MSB-first binary list of given length."""
    if length <= 0:
        return []
    return [int(b) for b in np.binary_repr(int(num) % (2 ** length),
                                           length)][-length:]


def bin2int(arr):
    """MSB-first binary iterable to integer."""
    out = 0
    for b in arr:
        out = (out << 1) | int(b)
    return out


def polynomial_selector(rate, constraint_length):
    """Industry-standard generator polynomials of a rate-1/2 or 1/3 code
    with constraint length 3-8."""
    if not isinstance(constraint_length, int):
        raise TypeError("constraint_length must be int.")
    if not 2 < constraint_length < 9:
        raise ValueError("Unsupported constraint_length.")
    if rate not in (1 / 2, 1 / 3):
        raise ValueError("Unsupported rate.")
    rate_half = {
        3: ("101", "111"),
        4: ("1101", "1011"),
        5: ("10011", "11011"),
        6: ("110101", "101111"),
        7: ("1011011", "1111001"),
        8: ("11100101", "10011111"),
    }
    rate_third = {
        3: ("101", "111", "111"),
        4: ("1011", "1101", "1111"),
        5: ("10101", "11011", "11111"),
        6: ("100111", "101011", "111101"),
        7: ("1111001", "1100101", "1011011"),
        8: ("10010101", "11011001", "11110111"),
    }
    return {1 / 2: rate_half, 1 / 3: rate_third}[rate][constraint_length]


class Trellis:
    """State-transition tables of a rate-1/n convolutional code
    (recursive systematic with ``rsc``: the first polynomial is the
    feedback)."""

    def __init__(self, gen_poly, rsc=True):
        self.rsc = rsc
        self.gen_poly = gen_poly
        self.constraint_length = len(gen_poly[0])
        self.conv_k = 1
        self.conv_n = len(gen_poly)
        self.ni = 2 ** self.conv_k
        self.ns = 2 ** (self.constraint_length - 1)
        self._mu = len(gen_poly[0]) - 1
        if self.rsc:
            self.fb_poly = [int(x) for x in gen_poly[0]]
            if self.fb_poly[0] != 1:
                raise ValueError("Feedback polynomial must start with 1")
        self._generate_transitions()

    def _output(self, state_bits):
        op = np.zeros(self.conv_n, int)
        for i, poly in enumerate(self.gen_poly):
            op[i] = sum(int(c) * s for c, s in zip(poly, state_bits)) % 2
        return op

    def _generate_transitions(self):
        ns, ni = self.ns, self.ni
        to_nodes = np.full((ns, ni), -1, int)
        from_nodes = np.full((ns, ni), -1, int)
        op_mat = np.full((ns, ns), -1, int)
        ip_by_tonode = np.full((ns, ni), -1, int)
        op_by_tonode = np.full((ns, ni), -1, int)
        op_by_fromnode = np.full((ns, ni), -1, int)
        ctr = np.zeros(ns, int)
        for i in range(ni):
            for j in range(ns):
                curr = int2bin(j, self.constraint_length - 1)
                if self.rsc:
                    fb = sum(b * p for b, p in zip(curr, self.fb_poly[1:])) % 2
                    new_bit = (i + fb) % 2
                else:
                    new_bit = i
                state_bits = [new_bit] + curr
                j_to = bin2int(state_bits[:-1])
                to_nodes[j][i] = j_to
                from_nodes[j_to][ctr[j_to]] = j
                op_sym = bin2int(self._output(state_bits))
                op_mat[j, j_to] = op_sym
                op_by_tonode[j_to, ctr[j_to]] = op_sym
                ip_by_tonode[j_to, ctr[j_to]] = i
                op_by_fromnode[j][i] = op_sym
                ctr[j_to] += 1
        self.to_nodes = to_nodes
        self.from_nodes = from_nodes
        self.op_mat = op_mat
        self.ip_by_tonode = ip_by_tonode
        self.op_by_tonode = op_by_tonode
        self.op_by_fromnode = op_by_fromnode
        # output bits per (from state, input): [ns, ni, conv_n]
        op_bits = np.zeros((ns, ni, self.conv_n), int)
        for j in range(ns):
            for i in range(ni):
                op_bits[j, i] = int2bin(op_by_fromnode[j][i], self.conv_n)
        self.op_bits_by_fromnode = op_bits

    def numpy_structure(self):
        """The transition tables, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {name: getattr(self, name) for name in (
            "to_nodes", "from_nodes", "op_mat", "ip_by_tonode",
            "op_by_tonode", "op_by_fromnode", "op_bits_by_fromnode")}
