"""PUSCH transmitter composite (counterpart of
``sionna_tpu/phy/nr/pusch_transmitter.py``)."""

import torch

from ..block import Block
from ..mapping import BinarySource, Mapper
from ..ofdm import OFDMModulator, ResourceGrid, ResourceGridMapper
from .config import Config
from .layer_mapping import LayerMapper
from .pusch_config import PUSCHConfig, check_pusch_configs
from .pusch_pilot_pattern import PUSCHPilotPattern
from .pusch_precoder import PUSCHPrecoder
from .tb_encoder import TBEncoder

__all__ = ["PUSCHTransmitter"]


class PUSCHTransmitter(Block):
    """Full 5G NR PUSCH transmit chain: TB encoding -> QAM mapping ->
    layer mapping -> resource grid (+DMRS) -> optional codebook
    precoding -> optional OFDM modulation.

    Called with a batch size (``return_bits=True``: random bits from
    ``generator``, else from the source's default stream) or with bits
    [batch, num_tx, tb_size]; returns x [batch, num_tx,
    num_antenna_ports, num_ofdm_symbols, num_subcarriers] (frequency
    domain) or [batch, num_tx, num_antenna_ports, num_time_samples]
    (time domain), and the bits when it drew them.
    """

    def __init__(self, pusch_configs, return_bits=True,
                 output_domain="freq", precision=None, verbose=False,
                 device=None):
        super().__init__(precision=precision, device=device)
        if not isinstance(return_bits, bool):
            raise TypeError("return_bits must be bool")
        self._return_bits = return_bits
        if output_domain not in ("time", "freq"):
            raise ValueError("output_domain must be 'time' or 'freq'")
        self._output_domain = output_domain
        self._verbose = bool(verbose)

        if isinstance(pusch_configs, PUSCHConfig):
            pusch_configs = [pusch_configs]
        params = check_pusch_configs(pusch_configs)
        for key, value in params.items():
            setattr(self, f"_{key}", value)
        self._pusch_configs = pusch_configs

        dev, prec = self.device, self.precision
        if self._return_bits:
            self._binary_source = BinarySource(precision=prec, device=dev)
        self._tb_encoder = TBEncoder(
            target_tb_size=self._tb_size,
            num_coded_bits=self._num_coded_bits,
            target_coderate=self._target_coderate,
            num_bits_per_symbol=self._num_bits_per_symbol,
            num_layers=self._num_layers, n_rnti=self._n_rnti,
            n_id=self._n_id, channel_type="PUSCH", codeword_index=0,
            use_scrambler=True, verbose=self._verbose, precision=prec,
            device=dev)
        self._layer_mapper = LayerMapper(num_layers=self._num_layers,
                                         precision=prec, device=dev)
        self._mapper = Mapper("qam", self._num_bits_per_symbol,
                              precision=prec, device=dev)
        self._pilot_pattern = PUSCHPilotPattern(self._pusch_configs,
                                                precision=prec)
        self._resource_grid = ResourceGrid(
            num_ofdm_symbols=self._num_ofdm_symbols,
            fft_size=self._num_subcarriers,
            subcarrier_spacing=self._subcarrier_spacing,
            num_tx=self._num_tx, num_streams_per_tx=self._num_layers,
            cyclic_prefix_length=self._cyclic_prefix_length,
            pilot_pattern=self._pilot_pattern, precision=prec)
        self._resource_grid_mapper = ResourceGridMapper(
            self._resource_grid, precision=prec, device=dev)
        if self._precoding == "codebook":
            self._precoder = PUSCHPrecoder(self._precoding_matrices,
                                           precision=prec, device=dev)
        if self._output_domain == "time":
            self._ofdm_modulator = OFDMModulator(
                self._cyclic_prefix_length, precision=prec, device=dev)

    @property
    def resource_grid(self):
        return self._resource_grid

    @property
    def pilot_pattern(self):
        return self._pilot_pattern

    def show(self):
        self._pusch_configs[0].carrier.show()
        Config.show(self._pusch_configs[0])
        for idx, p in enumerate(self._pusch_configs):
            print(f"---- UE {idx} ----")
            p.dmrs.show()
            p.tb.show()

    def forward(self, inputs, generator=None):
        if self._return_bits:
            batch_size = int(inputs)
            b = self._binary_source(
                [batch_size, self._num_tx, self._tb_size],
                generator=generator)
        else:
            b = torch.as_tensor(inputs).to(self.rdtype)
        c = self._tb_encoder(b)
        x_map = self._mapper(c)
        x_layer = self._layer_mapper(x_map)
        x = self._resource_grid_mapper(x_layer)
        if self._precoding == "codebook":
            x = self._precoder(x)
        if self._output_domain == "time":
            x = self._ofdm_modulator(x)
        if self._return_bits:
            return x, b
        return x
