"""Ordered statistics decoding.

PyTorch counterpart of ``sionna_tpu/phy/fec/linear/decoding.py``. Each
codeword's generator matrix, its columns sorted by reliability, is
row-reduced over GF(2) by a loop over the columns that runs on the whole
batch at once (per-codeword pivot rows, masked updates); all
:math:`\\sum_{i<=t} {k \\choose i}` candidate codewords are then one
batched GF(2) matrix product and a correlation.
"""

from itertools import combinations

import numpy as np
import torch

from ...block import Block
from ..utils import pcm2gm

__all__ = ["OSDecoder"]


class OSDecoder(Block):
    """Order-t ordered statistics decoder for arbitrary linear codes.

    Input llr_ch [..., n] as logits; output hard codeword estimates
    [..., n].
    """

    def __init__(self, enc_mat=None, t=0, is_pcm=False, encoder=None,
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if encoder is not None:
            # run the encoder once on the identity to get its generator
            k = getattr(encoder, "k", None)
            if k is None:
                raise ValueError(
                    "Cannot infer k from encoder; provide enc_mat.")
            eye = torch.eye(int(k), dtype=torch.float32,
                            device=encoder.device)
            gm = encoder(eye).cpu().numpy()
            self._gm = gm.astype(np.float32)
        else:
            enc_mat = np.asarray(enc_mat)
            if not np.all(np.isin(enc_mat, [0, 1])):
                raise ValueError("enc_mat must be binary.")
            self._gm = (pcm2gm(enc_mat) if is_pcm else enc_mat
                        ).astype(np.float32)
        self._k, self._n = self._gm.shape
        self._t = int(t)
        # error patterns of weight <= t over k positions
        patterns = [np.zeros(self._k, np.float32)]
        for w in range(1, self._t + 1):
            for pos in combinations(range(self._k), w):
                p = np.zeros(self._k, np.float32)
                p[list(pos)] = 1
                patterns.append(p)
        for name, value in (("_gm_t", self._gm),
                            ("_patterns", np.stack(patterns))):  # [P, k]
            self.register_buffer(name, torch.as_tensor(value,
                                                       device=self.device),
                                 persistent=False)

    @property
    def k(self):
        return self._k

    @property
    def n(self):
        return self._n

    @property
    def t(self):
        return self._t

    @property
    def coderate(self):
        return self._k / self._n

    def _gaussian_eliminate(self, g):
        """Row-reduces each g [B, k, n] over GF(2), pivoting on the
        columns in order. Returns (g_reduced, pivot_cols [B, k])."""
        k, n = self._k, self._n
        batch = g.shape[0]
        bi = torch.arange(batch, device=g.device)
        rows = torch.arange(k, device=g.device)
        r = torch.zeros(batch, dtype=torch.long, device=g.device)
        pivots = torch.zeros((batch, k), dtype=torch.long, device=g.device)
        for col in range(n):
            cand = torch.where((g[:, :, col] > 0) & (rows >= r[:, None]),
                               rows, k)
            p = cand.min(dim=1).values
            found = p < k
            p_safe = p.clamp(max=k - 1)
            r_safe = r.clamp(max=k - 1)
            # swap rows r and p
            swapped = g.clone()
            swapped[bi, r_safe] = g[bi, p_safe]
            swapped[bi, p_safe] = g[bi, r_safe]
            g = torch.where(found[:, None, None], swapped, g)
            # eliminate: every row with a 1 in col except row r
            pivot_row = g[bi, r_safe]
            mask = found[:, None] & (g[:, :, col] > 0) & (rows != r[:, None])
            g = torch.where(mask[:, :, None],
                            torch.remainder(g + pivot_row[:, None], 2), g)
            pivots[bi, r_safe] = torch.where(found, col, pivots[bi, r_safe])
            r = r + found.long()
        return g, pivots

    def forward(self, llr_ch):
        in_shape = llr_ch.shape
        llr = llr_ch.reshape(-1, self._n)
        # reliability order, most reliable first (stable, as JAX's sort)
        order = torch.argsort(-torch.abs(llr), dim=-1, stable=True)
        llr_p = torch.gather(llr, 1, order)
        g_p = self._gm_t.to(llr.dtype)[:, order].permute(1, 0, 2)
        g_red, pivots = self._gaussian_eliminate(g_p)
        # hard decisions at the pivot (most reliable basis) positions
        d = (torch.gather(llr_p, 1, pivots) > 0).to(llr.dtype)
        # candidates: flip <= t basis bits
        pat = self._patterns.to(llr.dtype)  # [P, k]
        u_cand = torch.remainder(d[:, None, :] + pat, 2)  # [B, P, k]
        c_cand = torch.remainder(torch.matmul(u_cand, g_red), 2)
        # correlation metric in the permuted domain; argmax takes the
        # first maximum, as JAX's does
        metric = torch.sum((2 * c_cand - 1) * llr_p[:, None, :], dim=-1)
        best = torch.argmax(metric, dim=-1)
        c_best_p = c_cand[torch.arange(llr.shape[0]), best]
        c_hat = torch.empty_like(c_best_p).scatter_(1, order, c_best_p)
        return c_hat.reshape(in_shape)
