"""Turbo code utilities: the constituent polynomials, the puncturing
patterns and the termination bit bookkeeping.

PyTorch-port counterpart of ``sionna_tpu/phy/fec/turbo/utils.py``.
"""

import math

import numpy as np
import torch

__all__ = ["polynomial_selector", "puncture_pattern", "TurboTermination"]


def polynomial_selector(constraint_length):
    """RSC generator polynomials of a turbo code's constituent codes
    (constraint length 3-6; 4 is the 3GPP code)."""
    if not isinstance(constraint_length, int):
        raise TypeError("constraint_length must be int.")
    if not 2 < constraint_length < 7:
        raise ValueError("Unsupported constraint_length.")
    return {3: ("111", "101"), 4: ("1011", "1101"), 5: ("10011", "11011"),
            6: ("111101", "101011")}[constraint_length]


def puncture_pattern(turbo_coderate, conv_coderate):
    """Puncturing pattern [rows, 3] (systematic, parity 1, parity 2) that
    gives ``turbo_coderate``."""
    if conv_coderate != 1 / 2:
        raise ValueError("Only conv_coderate 1/2 supported.")
    if turbo_coderate == 1 / 2:
        return np.array([[1, 1, 0], [1, 0, 1]], bool)
    if turbo_coderate == 1 / 3:
        return np.array([[1, 1, 1]], bool)
    raise NotImplementedError("turbo_coderate not supported")


class TurboTermination:
    """Merges and splits the constituent encoders' termination bits to
    and from the turbo bit streams."""

    def __init__(self, constraint_length, conv_n=2, num_conv_encs=2,
                 num_bitstreams=3):
        self.mu_ = int(constraint_length) - 1
        self.conv_n = int(conv_n)
        if num_conv_encs != 2:
            raise NotImplementedError("Only num_conv_encs=2 supported.")
        self.num_conv_encs = num_conv_encs
        self.num_bitstreams = int(num_bitstreams)

    def get_num_term_syms(self):
        total_term_bits = self.conv_n * self.num_conv_encs * self.mu_
        return math.ceil(total_term_bits / self.num_bitstreams)

    def termbits_conv2turbo(self, term_bits1, term_bits2):
        """Concatenates the two termination streams [batch, ...] and
        zero-pads to a multiple of ``num_bitstreams``."""
        term = torch.cat([term_bits1, term_bits2], dim=-1)
        pad = -term.shape[-1] % self.num_bitstreams
        return torch.nn.functional.pad(term, (0, pad))

    def term_bits_turbo2conv(self, term_bits):
        """Splits the turbo termination bits back into the two
        constituent streams."""
        n1 = self.conv_n * self.mu_
        return term_bits[..., :n1], term_bits[..., n1:2 * n1]
