"""PUSCH receiver composite (counterpart of
``sionna_tpu/phy/nr/pusch_receiver.py``)."""

import numpy as np
import torch

from ..block import Block
from ..channel import time_to_ofdm_channel
from ..mimo import StreamManagement
from ..ofdm import LinearDetector, OFDMDemodulator
from .layer_mapping import LayerDemapper
from .pusch_channel_estimation import PUSCHLSChannelEstimator
from .tb_decoder import TBDecoder

__all__ = ["PUSCHReceiver"]


class PUSCHReceiver(Block):
    """Full 5G NR PUSCH receive chain: (OFDM demod) -> channel
    estimation -> MIMO detection -> layer demapping -> TB decoding.

    Called with y [batch, num_rx, num_rx_ant, num_ofdm_symbols,
    fft_size] (or [..., num_time_samples] for ``input_domain="time"``),
    the noise variance ``no`` and, for ``channel_estimator="perfect"``,
    the channel ``h``; returns the decoded bits [batch, num_tx, tb_size]
    (and the TB CRC status).
    """

    def __init__(self, pusch_transmitter, channel_estimator=None,
                 mimo_detector=None, tb_decoder=None,
                 return_tb_crc_status=False, stream_management=None,
                 input_domain="freq", l_min=None, precision=None,
                 device=None):
        super().__init__(precision=precision, device=device)
        if input_domain not in ("time", "freq"):
            raise ValueError("input_domain must be 'time' or 'freq'")
        dev, prec = self.device, self.precision
        tx = pusch_transmitter
        self._input_domain = input_domain
        self._return_tb_crc_status = bool(return_tb_crc_status)
        self._resource_grid = tx.resource_grid

        if input_domain == "time":
            if l_min is None:
                raise ValueError(
                    "l_min must be provided for input_domain==time")
            self._l_min = l_min
            self._ofdm_demodulator = OFDMDemodulator(
                fft_size=tx._num_subcarriers, l_min=l_min,
                cyclic_prefix_length=tx._cyclic_prefix_length,
                precision=prec, device=dev)

        self._perfect_csi = False
        w = None
        if channel_estimator is None:
            self._channel_estimator = PUSCHLSChannelEstimator(
                self._resource_grid, tx._dmrs_length,
                tx._dmrs_additional_position,
                tx._num_cdm_groups_without_data,
                interpolation_type="lin", precision=prec, device=dev)
        elif channel_estimator == "perfect":
            self._perfect_csi = True
            if tx._precoding == "codebook":
                # [tx, P, L] -> [tx, 1, 1, P, L]
                w = tx._precoder._w[:, None, None].to(device=dev,
                                                      dtype=self.cdtype)
        else:
            self._channel_estimator = channel_estimator
        self.register_buffer("_w", w, persistent=False)

        if stream_management is None:
            rx_tx_association = np.ones([1, tx._num_tx], bool)
            self._stream_management = StreamManagement(
                rx_tx_association, tx._num_layers)
        else:
            self._stream_management = stream_management

        if mimo_detector is None:
            self._mimo_detector = LinearDetector(
                "lmmse", "bit", "maxlog", tx.resource_grid,
                self._stream_management, "qam", tx._num_bits_per_symbol,
                precision=prec, device=dev)
        else:
            self._mimo_detector = mimo_detector

        self._layer_demapper = LayerDemapper(
            tx._layer_mapper, num_bits_per_symbol=tx._num_bits_per_symbol,
            precision=prec, device=dev)
        if tb_decoder is None:
            self._tb_decoder = TBDecoder(tx._tb_encoder, precision=prec,
                                         device=dev)
        else:
            self._tb_decoder = tb_decoder

    @property
    def resource_grid(self):
        return self._resource_grid

    def forward(self, y, no, h=None):
        if self._input_domain == "time":
            y = self._ofdm_demodulator(y)
        if self._perfect_csi:
            if h is None:
                raise ValueError("h must be provided for perfect CSI")
            h = torch.as_tensor(h).to(self.cdtype)
            if self._input_domain == "time":
                h = time_to_ofdm_channel(h, self._resource_grid,
                                         self._l_min)
            if self._w is not None:
                # apply the precoding to the channel:
                # h: [b, rx, rxa, tx, txa, sym, sc]
                h = h.permute(0, 1, 3, 5, 6, 2, 4)
                h = torch.matmul(h, self._w.to(h.device))
                h = h.permute(0, 1, 5, 2, 6, 3, 4)
            h_hat = h
            err_var = torch.zeros((1,) * h_hat.dim(), dtype=self.rdtype,
                                  device=h_hat.device)
        else:
            h_hat, err_var = self._channel_estimator(y, no)
        llr = self._mimo_detector(y, h_hat, err_var, no)
        llr = self._layer_demapper(llr)
        b_hat, tb_crc_status = self._tb_decoder(llr)
        if self._return_tb_crc_status:
            return b_hat, tb_crc_status
        return b_hat
