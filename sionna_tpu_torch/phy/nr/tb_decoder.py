"""Transport block decoder (counterpart of
``sionna_tpu/phy/nr/tb_decoder.py``).

Descrambling, the filler LLRs of the shorter code blocks and the inverse
output permutation are one sign flip, one concatenation and one gather;
every code block of every transport block then goes through one
``LDPC5GDecoder`` call, which on a CUDA tensor is one launch of the
lifted kernel of its check-node rule (K1; min-sum is its K2 case) and on
a CPU tensor the plain lifted decode.
"""

import numpy as np
import torch

from ..block import Block
from ..fec.crc import CRCDecoder
from ..fec.ldpc import LDPC5GDecoder
from ..fec.scrambling import Descrambler
from .tb_encoder import TBEncoder

__all__ = ["TBDecoder"]


class TBDecoder(Block):
    """Descramble -> de-interleave -> de-segment -> LDPC decode ->
    CB/TB CRC. Returns (b_hat, tb_crc_status).

    Input [..., num_tx, n] channel logits -> (bits [..., num_tx, k],
    TB CRC status [..., num_tx] bool).
    """

    def __init__(self, encoder, num_bp_iter=20,
                 cn_update="boxplus-phi", vn_update="sum",
                 precision=None, device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(encoder, TBEncoder):
            raise TypeError("encoder must be TBEncoder.")
        dev = self.device
        self._tb_encoder = encoder
        self._num_cbs = encoder.num_cbs
        self._decoder = LDPC5GDecoder(
            encoder=encoder.ldpc_encoder, num_iter=num_bp_iter,
            cn_update=cn_update, vn_update=vn_update, hard_out=True,
            return_infobits=True, precision=precision, device=dev)
        self._descrambler = Descrambler(
            encoder.scrambler, binary=False, precision=precision,
            device=dev) if encoder.scrambler is not None else None
        self._tb_crc_decoder = CRCDecoder(encoder.tb_crc_encoder,
                                          precision=precision, device=dev)
        self._cb_crc_decoder = CRCDecoder(
            encoder.cb_crc_encoder, precision=precision, device=dev) \
            if encoder.cb_crc_encoder is not None else None
        self._num_fillers = (encoder.ldpc_encoder.n * encoder.num_cbs
                             - int(np.sum(encoder.cw_lengths)))
        self.register_buffer(
            "_perm_inv", torch.as_tensor(encoder.output_perm_inv,
                                         dtype=torch.int64, device=dev),
            persistent=False)

    @property
    def tb_size(self):
        return self._tb_encoder.tb_size

    @property
    def k(self):
        return self._tb_encoder.tb_size

    @property
    def n(self):
        return self._tb_encoder.n

    def forward(self, inputs):
        enc = self._tb_encoder
        llr_ch = torch.as_tensor(inputs).to(self.rdtype)
        input_shape = llr_ch.shape
        llr_ch = llr_ch.reshape(-1, enc.num_tx, enc.n)
        if self._descrambler is not None:
            llr_ch = self._descrambler(llr_ch)
        llr_int = torch.cat(
            [llr_ch, torch.zeros((llr_ch.shape[0], enc.num_tx,
                                  self._num_fillers), dtype=llr_ch.dtype,
                                 device=llr_ch.device)], dim=-1)
        llr_int = torch.index_select(llr_int, -1,
                                     self._perm_inv.to(llr_int.device))
        llr_cb = llr_int.reshape(-1, enc.num_tx, self._num_cbs,
                                 enc.ldpc_encoder.n)
        u_hat_cb = self._decoder(llr_cb)
        if self._cb_crc_decoder is not None:
            u_hat_cb, _ = self._cb_crc_decoder(u_hat_cb)
        u_hat_tb = u_hat_cb.reshape(
            -1, enc.num_tx, self.tb_size + enc.tb_crc_encoder.crc_length)
        u_hat, tb_crc_status = self._tb_crc_decoder(u_hat_tb)
        out_shape = list(input_shape)
        out_shape[-1] = self.tb_size
        u_hat = u_hat.reshape(out_shape)
        tb_crc_status = tb_crc_status.reshape(out_shape[:-1])
        if enc.k_padding > 0:
            u_hat = u_hat[..., :-enc.k_padding]
        return u_hat.to(self.rdtype), tb_crc_status
