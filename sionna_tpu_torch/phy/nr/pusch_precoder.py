"""PUSCH codebook precoder (counterpart of
``sionna_tpu/phy/nr/pusch_precoder.py``; TS 38.211 Table 6.3.1.5)."""

import numpy as np
import torch

from ..block import Block

__all__ = ["PUSCHPrecoder"]


class PUSCHPrecoder(Block):
    """Precodes layer-mapped resource grids with per-transmitter
    codebook matrices (NumPy, cast to the block's complex dtype).

    Input [batch, num_tx, num_layers, num_sym, num_sc] ->
    [batch, num_tx, num_antenna_ports, num_sym, num_sc].
    """

    def __init__(self, precoding_matrices, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        shape = precoding_matrices[0].shape
        for w in precoding_matrices:
            if w.shape != shape:
                raise ValueError(
                    "All precoding matrices must have the same shape")
        w = np.stack([np.asarray(w) for w in precoding_matrices])
        self.register_buffer(  # [tx, P, L]
            "_w", torch.as_tensor(w.astype(self.np_cdtype),
                                  device=self.device), persistent=False)

    def forward(self, inputs):
        x = inputs
        if x.shape[1] != self._w.shape[0]:
            raise ValueError("Wrong number of transmitters")
        if x.shape[2] != self._w.shape[2]:
            raise ValueError("Wrong number of layers")
        # [b, tx, L, sym, sc] -> [b, sym, sc, tx, L, 1]
        xt = x.permute(0, 3, 4, 1, 2)[..., None]
        z = torch.matmul(self._w.to(x.device), xt)[..., 0]
        return z.permute(0, 3, 4, 1, 2)  # [b, tx, P, sym, sc]
