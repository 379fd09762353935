"""The 4 x 4 MIMO-OFDM uplink over CDL-B of ``mimo_ofdm_cdl.json``
(BASELINE config 3), built from ``sionna_tpu_torch``'s public blocks as
``sionna_tpu_torch/examples/03_mimo_ofdm_cdl.py`` composes it, and its
reference (``reference/mimo_ofdm_cdl.py``).

The link's MC call marks the start of each layer (``rec.mark``) and
hands the tensors the check compares to the harness (``rec.keep``); the
CDL hands over each draw (a, tau) through ``rec.keeping``. All are
no-ops unless the harness arms them."""

import numpy as np

from sionna_tpu_torch.phy import BinarySource, Mapper
from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import CDL, AntennaArray
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.ofdm import (LinearDetector, LSChannelEstimator,
                                       ResourceGrid, ResourceGridMapper)
from sionna_tpu_torch.phy.utils import ebnodb2no

from reference.mimo_ofdm_cdl import MimoOfdmCdlReference, minsum_work


class Link:
    """One MC iteration of the config-3 link (the ``sim_ber`` model):
    [batch, 1, streams, k] info bits and their decisions."""

    def __init__(self, cfg, traffic, device, rec):
        self.rec, self.dev = rec, device
        self._no = {}   # Eb/No (dB) -> N0 on the device
        rgc, ch, rx = cfg["resource_grid"], cfg["channel"], cfg["receiver"]
        self.nbps = m = cfg["num_bits_per_symbol"]
        self.rate = cfg["coderate"]
        self.streams = rgc["num_streams_per_tx"]
        self.rg = rg = ResourceGrid(
            num_ofdm_symbols=rgc["num_ofdm_symbols"],
            fft_size=rgc["fft_size"],
            subcarrier_spacing=rgc["subcarrier_spacing_hz"],
            num_tx=rgc["num_tx"], num_streams_per_tx=self.streams,
            cyclic_prefix_length=rgc["cyclic_prefix_length"],
            pilot_pattern=rgc["pilot_pattern"],
            pilot_ofdm_symbol_indices=rgc["pilot_ofdm_symbol_indices"])
        n = int(rg.num_data_symbols) * m
        self.k = k = int(n * self.rate)
        if (k, n) != (cfg["code"]["k"], cfg["code"]["n"]):
            raise ValueError(f"the grid gives (k, n) = {(k, n)}")
        self.src = BinarySource(device=device)
        self.enc = LDPC5GEncoder(k, n, device=device)
        self.mapper = Mapper("qam", m, device=device)
        self.rg_mapper = ResourceGridMapper(rg, device=device)
        fc = ch["carrier_frequency_hz"]
        ut = AntennaArray(carrier_frequency=fc, **ch["ut_array"])
        bs = AntennaArray(carrier_frequency=fc, **ch["bs_array"])
        cdl = CDL(ch["profile"], ch["delay_spread_s"], fc, ut, bs,
                  ch["direction"], min_speed=ch["min_speed_m_s"],
                  device=device)
        self.channel = OFDMChannel(
            rec.keeping(cdl), rg, normalize_channel=ch["normalize_channel"],
            return_channel=True, device=device)
        self.est = LSChannelEstimator(
            rg, interpolation_type=rx["interpolation"], device=device)
        self.det = LinearDetector(
            rx["detector"], rx["output"], rx["demapping"], rg,
            StreamManagement(np.array([[1]]), self.streams), "qam", m,
            device=device)
        dec = rx["decoder"]
        self.dec = LDPC5GDecoder(
            self.enc, cn_update=dec["cn_update"], hard_out=dec["hard_out"],
            num_iter=dec["num_iter"], cn_schedule=dec["cn_schedule"],
            device=device)

    def __call__(self, batch_size, ebno_db):
        rec = self.rec
        rec.mark("tx")
        no = self._no.get(float(ebno_db))
        if no is None:
            # once an Eb/No: N0 handed to the blocks as a host scalar
            # costs a blocking copy, a host sync, every iteration
            no = self._no[float(ebno_db)] = ebnodb2no(
                ebno_db, self.nbps, self.rate, self.rg).to(self.dev)
        b = self.src([batch_size, 1, self.streams, self.k])
        x = self.rg_mapper(self.mapper(self.enc(b)))
        rec.mark("channel")
        y, h = self.channel(x, no)
        rec.mark("estimation")
        h_hat, err_var = self.est(y, no)
        rec.mark("detection")
        llr = self.det(y, h_hat, err_var, no)
        rec.mark("decode")
        b_hat = self.dec(llr)
        rec.keep(b=b, x=x, h=h, y=y, llr=llr, b_hat=b_hat)
        return b, b_hat


def build(cfg, traffic, device, rec):
    return Link(cfg, traffic, device, rec)


def reference(cfg, traffic):
    return MimoOfdmCdlReference(cfg, traffic)


def work(cfg, traffic):
    """Operations and bytes of one decoder launch: the batch's 4
    codewords per grid in one call, counted for the min-sum check node.
    The key is ``k1``: the launch is K1's kernel (``lifted_bp_kernel``)
    in its min-sum mode, so ``metrics/k1.roofline_pct.py`` reads it
    against this count."""
    ref = MimoOfdmCdlReference(cfg, traffic)
    return {"k1": minsum_work(
        ref.code, cfg["resource_grid"]["num_streams_per_tx"]
        * traffic["batch_size"], cfg["receiver"]["decoder"]["num_iter"])}
