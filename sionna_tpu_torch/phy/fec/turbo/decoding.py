"""Iterative turbo decoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/turbo/decoding.py``: two
soft-output BCJR constituent decoders exchange extrinsic information
through the internal interleaver for a fixed number of iterations.
"""

import numpy as np
import torch

from ...block import Block
from .. import interleaving
from ..conv.decoding import BCJRDecoder
from ..conv.utils import Trellis
from .encoding import TurboEncoder, _punct_keep
from .utils import polynomial_selector, puncture_pattern, TurboTermination

__all__ = ["TurboDecoder"]

_LLR_MAX = 20.0


class TurboDecoder(Block):
    """Iterative BCJR turbo decoder.

    Input llr [..., n] as logits; output hard (or, with
    ``hard_out=False``, soft) info bits [..., k].
    """

    def __init__(self, encoder=None, gen_poly=None, constraint_length=3,
                 rate=1 / 3, terminate=False, num_iter=6, hard_out=True,
                 algorithm="map", interleaver_type="3GPP", precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        dev = self.device
        if encoder is not None:
            if not isinstance(encoder, TurboEncoder):
                raise TypeError("encoder must be a TurboEncoder")
            self._gen_poly = encoder.gen_poly
            self._terminate = encoder.terminate
            self._coderate = encoder.coderate
            self._punct_pattern = encoder.punct_pattern
            self.internal_interleaver = encoder.internal_interleaver
        else:
            self._gen_poly = gen_poly if gen_poly is not None \
                else polynomial_selector(constraint_length)
            self._terminate = bool(terminate)
            self._coderate = rate
            self._punct_pattern = puncture_pattern(rate, 1 / 2)
            if interleaver_type == "3GPP":
                self.internal_interleaver = \
                    interleaving.Turbo3GPPInterleaver(device=dev)
            else:
                self.internal_interleaver = interleaving.RandomInterleaver(
                    keep_batch_constant=True, keep_state=True, axis=-1,
                    device=dev)
        self._trellis = Trellis(self._gen_poly, rsc=True)
        self._mu = self._trellis._mu
        self._conv_n = self._trellis.conv_n
        self._num_iter = int(num_iter)
        self._hard_out = bool(hard_out)
        self._term_syms = 0
        if self._terminate:
            self.turbo_term = TurboTermination(self._mu + 1,
                                               conv_n=self._conv_n)
            self._term_syms = self.turbo_term.get_num_term_syms()
        self._bcjr = BCJRDecoder(gen_poly=self._gen_poly, rsc=True,
                                 terminate=self._terminate, hard_out=False,
                                 algorithm=algorithm, precision=precision,
                                 device=dev)
        self._k = None
        self._n = None

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
    def num_iter(self):
        return self._num_iter

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    def _depuncture(self, llr, k):
        """Scatters ``llr`` back onto the [syms, 3] grid, zeros at the
        punctured positions (the termination symbols are never
        punctured)."""
        syms = k + self._term_syms
        keep = _punct_keep(self._punct_pattern, k)
        keep = np.concatenate([keep, 3 * k + np.arange(3 * self._term_syms)])
        full = llr.new_zeros((llr.shape[0], syms * 3))
        full[:, torch.as_tensor(keep, device=llr.device)] = llr
        return full.reshape(-1, syms, 3)

    def forward(self, llr_ch, /):
        llr = torch.as_tensor(llr_ch).to(self.rdtype)
        in_shape = llr.shape
        n = llr.shape[-1]
        self._n = n
        llr = llr.reshape(-1, n)
        pattern = self._punct_pattern
        k = int((n - 3 * self._term_syms) * pattern.shape[0] // pattern.sum())
        self._k = k
        y = self._depuncture(llr, k)  # [batch, syms, 3]
        sys_llr, par1, par2 = y[:, :k, 0], y[:, :k, 1], y[:, :k, 2]
        sys2_llr = self.internal_interleaver(sys_llr)
        # constituent codewords: systematic and parity per symbol
        y1 = torch.stack([sys_llr, par1], dim=-1).reshape(sys_llr.shape[0], -1)
        y2 = torch.stack([sys2_llr, par2], dim=-1).reshape(
            sys_llr.shape[0], -1)
        if self._terminate:
            t1, t2 = self.turbo_term.term_bits_turbo2conv(
                y[:, k:].reshape(y.shape[0], -1))
            y1 = torch.cat([y1, t1], dim=-1)
            y2 = torch.cat([y2, t2], dim=-1)
        llr_1e = llr.new_zeros((llr.shape[0], k))
        llr_2i = torch.zeros_like(sys2_llr)
        for _ in range(self._num_iter):
            llr_1i = self._bcjr(y1, prior=llr_1e)
            llr_2e = torch.clamp(
                self.internal_interleaver(llr_1i - sys_llr - llr_1e),
                -_LLR_MAX, _LLR_MAX)
            llr_2i = self._bcjr(y2, prior=llr_2e)
            llr_1e = torch.clamp(
                self.internal_interleaver(llr_2i - llr_2e - sys2_llr,
                                          inverse=True),
                -_LLR_MAX, _LLR_MAX)
        out = self.internal_interleaver(llr_2i, inverse=True)
        if self._hard_out:
            out = (out > 0).to(self.rdtype)
        return out.reshape(tuple(in_shape[:-1]) + (k,))
