"""Transport block encoder per TS 38.214/38.211 (counterpart of
``sionna_tpu/phy/nr/tb_encoder.py``).

The segmentation, the code-block lengths and the output permutation
(per-code-block interleaver and concatenation, the shorter code blocks'
tails last) are computed once on the host in NumPy, as in the JAX
package; a call is the CRCs, one ``LDPC5GEncoder`` call over every code
block, one gather and the scrambler on the input's device.
"""

import numpy as np
import torch

from ..block import Block
from ..fec.crc import CRCEncoder
from ..fec.ldpc import LDPC5GEncoder
from ..fec.scrambling import TB5GScrambler
from .utils import calculate_tb_size

__all__ = ["TBEncoder"]


class TBEncoder(Block):
    """TB-CRC -> CB segmentation (+CB-CRC) -> LDPC -> rate matching +
    interleaving -> scrambling -> concatenation.

    Input [..., num_tx, k] (``num_tx`` = the number of ``n_rnti``/``n_id``
    pairs) -> [..., num_tx, n] bits.
    """

    def __init__(self, target_tb_size, num_coded_bits, target_coderate,
                 num_bits_per_symbol, num_layers=1, n_rnti=1, n_id=1,
                 channel_type="PUSCH", codeword_index=0,
                 use_scrambler=True, verbose=False, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if channel_type not in ("PUSCH", "PDSCH"):
            raise ValueError("Invalid channel_type")
        self._target_tb_size = int(target_tb_size)
        self._num_coded_bits = int(num_coded_bits)
        self._target_coderate = float(target_coderate)
        self._num_bits_per_symbol = int(num_bits_per_symbol)
        self._num_layers = int(num_layers)
        self._use_scrambler = bool(use_scrambler)

        if isinstance(n_rnti, (list, tuple)):
            if not isinstance(n_id, (list, tuple)) \
                    or len(n_rnti) != len(n_id):
                raise ValueError(
                    "n_rnti and n_id must be lists of same length")
            self._n_rnti = [int(n) for n in n_rnti]
            self._n_id = [int(n) for n in n_id]
        else:
            self._n_rnti = [int(n_rnti)]
            self._n_id = [int(n_id)]
        self._num_tx = len(self._n_id)

        tbconfig = calculate_tb_size(
            target_tb_size=self._target_tb_size,
            num_coded_bits=self._num_coded_bits,
            target_coderate=self._target_coderate,
            modulation_order=self._num_bits_per_symbol,
            num_layers=self._num_layers, verbose=verbose)
        self._tb_size = int(tbconfig[0])
        self._cb_size = int(tbconfig[1])
        self._num_cbs = int(tbconfig[2])
        self._tb_crc_length = int(tbconfig[3])
        self._cb_crc_length = int(tbconfig[4])
        self._cw_lengths = np.asarray(tbconfig[5]).reshape(-1)
        if self._tb_size > self._tb_crc_length \
                + np.sum(self._cw_lengths):
            raise ValueError("Invalid TB parameters.")
        self._k_padding = self._tb_size - self._target_tb_size
        if self._tb_size != self._target_tb_size and verbose:
            print(f"Note: actual tb_size={self._tb_size} differs from "
                  f"target_tb_size={self._target_tb_size}; zero "
                  f"padding applied.")
        self._coderate = self._tb_size / self._num_coded_bits

        dev = self.device
        self._tb_crc_encoder = CRCEncoder(
            "CRC16" if self._tb_crc_length == 16 else "CRC24A",
            precision=precision, device=dev)
        self._cb_crc_encoder = CRCEncoder(
            "CRC24B", precision=precision, device=dev) \
            if self._cb_crc_length == 24 else None
        self._scrambler = TB5GScrambler(
            n_rnti=self._n_rnti, n_id=self._n_id, binary=True,
            channel_type=channel_type, codeword_index=codeword_index,
            precision=precision, device=dev) if use_scrambler else None

        self._encoder = LDPC5GEncoder(
            self._cb_size, int(np.max(self._cw_lengths)),
            num_bits_per_symbol=1, precision=precision, device=dev)

        # per-codeword output interleaver + concatenation permutation
        cw_min = int(np.min(self._cw_lengths))
        cw_max = int(np.max(self._cw_lengths))
        perm_short, _ = self._encoder.generate_out_int(
            cw_min, num_bits_per_symbol)
        perm_long, _ = self._encoder.generate_out_int(
            cw_max, num_bits_per_symbol)
        perm_seq = []
        perm_seq_punc = []
        pos = 0
        for length in self._cw_lengths:
            if length == cw_min:
                perm_seq = np.concatenate([perm_seq, perm_short + pos])
                r = np.arange(pos + cw_min, pos + cw_max)
                perm_seq_punc = np.concatenate([perm_seq_punc, r])
                pos += cw_max
            elif length == cw_max:
                perm_seq = np.concatenate([perm_seq, perm_long + pos])
                pos += length
            else:
                raise ValueError("Invalid cw_lengths.")
        perm_seq = np.concatenate([perm_seq, perm_seq_punc])
        self._output_perm = perm_seq.astype(np.int32)
        self._output_perm_inv = np.argsort(perm_seq).astype(np.int32)
        self.register_buffer(
            "_perm", torch.as_tensor(
                self._output_perm[:int(np.sum(self._cw_lengths))],
                dtype=torch.int64, device=dev), persistent=False)

    # ------------------------------------------------------------------
    @property
    def tb_size(self):
        return self._tb_size

    @property
    def k(self):
        return self._target_tb_size

    @property
    def k_padding(self):
        return self._k_padding

    @property
    def n(self):
        return self._num_coded_bits

    @property
    def num_cbs(self):
        return self._num_cbs

    @property
    def cb_size(self):
        return self._cb_size

    @property
    def coderate(self):
        return self._coderate

    @property
    def ldpc_encoder(self):
        return self._encoder

    @property
    def scrambler(self):
        return self._scrambler

    @property
    def tb_crc_encoder(self):
        return self._tb_crc_encoder

    @property
    def cb_crc_encoder(self):
        return self._cb_crc_encoder

    @property
    def num_tx(self):
        return self._num_tx

    @property
    def cw_lengths(self):
        return self._cw_lengths

    @property
    def tb_crc_length(self):
        return self._tb_crc_length

    @property
    def output_perm_inv(self):
        return self._output_perm_inv

    # ------------------------------------------------------------------
    def forward(self, inputs):
        u = torch.as_tensor(inputs).to(self.rdtype)
        input_shape = u.shape
        if input_shape[-1] != self.k:
            raise ValueError(
                f"Invalid input shape. Expected TB length {self.k}.")
        if self._k_padding > 0:
            pad = torch.zeros(u.shape[:-1] + (self._k_padding,),
                              dtype=u.dtype, device=u.device)
            u = torch.cat([u, pad], dim=-1)
        u_crc = self._tb_crc_encoder(u)
        u_cb = u_crc.reshape(-1, self._num_tx, self._num_cbs,
                             self._cb_size - self._cb_crc_length)
        if self._cb_crc_length == 24:
            u_cb = self._cb_crc_encoder(u_cb)
        c_cb = self._encoder(u_cb)
        c = c_cb.reshape(-1, self._num_tx,
                         self._num_cbs * int(np.max(self._cw_lengths)))
        # the permutation, truncated to the transmitted bits
        c = torch.index_select(c, -1, self._perm.to(c.device))
        if self._use_scrambler:
            c = self._scrambler(c)
        out_shape = tuple(input_shape[:-1]) + (c.shape[-1],)
        return c.reshape(out_shape).to(self.rdtype)
