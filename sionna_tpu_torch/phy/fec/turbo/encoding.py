"""Turbo encoding (3GPP LTE, TS 36.212).

PyTorch counterpart of ``sionna_tpu/phy/fec/turbo/encoding.py``: two
recursive systematic convolutional encoders, the second fed through the
internal interleaver, optional termination and rate-1/2 puncturing.
"""

import numpy as np
import torch

from ...block import Block
from .. import interleaving
from ..conv.encoding import ConvEncoder
from ..conv.utils import Trellis
from .utils import polynomial_selector, puncture_pattern, TurboTermination

__all__ = ["TurboEncoder"]


def _punct_keep(pattern, rows):
    """Flat indices kept of a [rows, 3] grid under the tiled puncturing
    ``pattern``."""
    reps = int(np.ceil(rows / pattern.shape[0]))
    mask = np.tile(pattern, (reps, 1))[:rows]
    return np.flatnonzero(mask.reshape(-1))


class TurboEncoder(Block):
    """Parallel-concatenated RSC turbo encoder with the 3GPP (or a
    random) interleaver, optional termination and rate-1/2 puncturing.

    Input [..., k] -> output [..., n].
    """

    def __init__(self, gen_poly=None, constraint_length=3, rate=1 / 3,
                 terminate=False, interleaver_type="3GPP", precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if gen_poly is not None:
            if len(gen_poly) != 2:
                raise ValueError("Generator polynomials need to be of "
                                 "rate-1/2")
            self._gen_poly = gen_poly
        else:
            self._gen_poly = polynomial_selector(constraint_length)
        if rate not in (1 / 2, 1 / 3):
            raise ValueError("Invalid coderate.")
        if interleaver_type not in ("3GPP", "random"):
            raise ValueError("Invalid interleaver_type.")
        self._coderate = rate
        self._terminate = bool(terminate)
        self._interleaver_type = interleaver_type
        self._coderate_conv = 1 / len(self._gen_poly)
        self._punct_pattern = puncture_pattern(rate, self._coderate_conv)
        self._trellis = Trellis(self._gen_poly, rsc=True)
        self._mu = self._trellis._mu
        self._conv_n = self._trellis.conv_n
        self._k = None
        self._n = None
        if self._terminate:
            self.turbo_term = TurboTermination(self._mu + 1,
                                               conv_n=self._conv_n)
        dev = self.device
        if interleaver_type == "3GPP":
            self.internal_interleaver = interleaving.Turbo3GPPInterleaver(
                device=dev)
        else:
            self.internal_interleaver = interleaving.RandomInterleaver(
                keep_batch_constant=True, keep_state=True, axis=-1,
                device=dev)
        self.convencoder = ConvEncoder(gen_poly=self._gen_poly, rsc=True,
                                       terminate=self._terminate,
                                       device=dev)

    @property
    def gen_poly(self):
        return self._gen_poly

    @property
    def constraint_length(self):
        return self._mu + 1

    @property
    def coderate(self):
        return self._coderate

    @property
    def trellis(self):
        return self._trellis

    @property
    def terminate(self):
        return self._terminate

    @property
    def punct_pattern(self):
        return self._punct_pattern

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    def forward(self, bits):
        bits = torch.as_tensor(bits).to(self.rdtype)
        k = bits.shape[-1]
        self._k = k
        in_shape = bits.shape
        msg = bits.reshape(-1, k)
        cw1_ = self.convencoder(msg)
        cw2_ = self.convencoder(self.internal_interleaver(msg))
        preterm_n = int(k / self._coderate_conv)
        cw1, term1 = cw1_[:, :preterm_n], cw1_[:, preterm_n:]
        cw2, term2 = cw2_[:, :preterm_n], cw2_[:, preterm_n:]
        # [systematic, parity 1] of the first encoder, parity of the second
        cw = torch.cat([cw1.reshape(-1, k, self._conv_n),
                        cw2[:, 1::self._conv_n, None]], dim=-1)
        if self._terminate:
            term = self.turbo_term.termbits_conv2turbo(term1, term2)
            cw = torch.cat([cw, term.reshape(-1, term.shape[-1] // 3, 3)],
                           dim=-2)
        keep = torch.as_tensor(_punct_keep(self._punct_pattern,
                                           cw.shape[1]), device=cw.device)
        out = torch.index_select(cw.reshape(cw.shape[0], -1), -1, keep)
        self._n = out.shape[-1]
        return out.reshape(tuple(in_shape[:-1]) + (self._n,))
