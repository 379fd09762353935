"""The flagship TDL-A OFDM link of ``flagship_tdla.json``, built from
``sionna_tpu_torch``'s public blocks as upstream's Discover_Sionna
notebook composes it, and its reference (``reference/flagship_tdla.py``).

The link's MC call marks the start of each layer (``rec.mark``) and
hands the tensors the check compares to the harness (``rec.keep``); both
are no-ops unless the harness arms them."""

import numpy as np

from sionna_tpu_torch.phy import BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import TDL
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RowColumnInterleaver)
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.ofdm import (LMMSEEqualizer, LSChannelEstimator,
                                       ResourceGrid, ResourceGridMapper)
from sionna_tpu_torch.phy.utils import ebnodb2no

from reference.flagship_tdla import FlagshipReference
from reference.work import lifted_bp_work

class Link:
    """One MC iteration of the flagship link (the ``sim_ber`` model)."""

    def __init__(self, cfg, traffic, device, rec):
        self.rec = rec
        self.dev = device
        rgc, ch = cfg["resource_grid"], cfg["channel"]
        self.nbps = m = cfg["num_bits_per_symbol"]
        self.rate = cfg["coderate"]
        self.rg = rg = ResourceGrid(
            num_ofdm_symbols=rgc["num_ofdm_symbols"],
            fft_size=rgc["fft_size"],
            subcarrier_spacing=rgc["subcarrier_spacing_hz"],
            num_tx=rgc["num_tx"], num_streams_per_tx=rgc["num_streams_per_tx"],
            cyclic_prefix_length=rgc["cyclic_prefix_length"],
            pilot_pattern=rgc["pilot_pattern"],
            pilot_ofdm_symbol_indices=rgc["pilot_ofdm_symbol_indices"])
        n = int(rg.num_data_symbols) * m
        self.k = k = int(n * self.rate)
        if (k, n) != (cfg["code"]["k"], cfg["code"]["n"]):
            raise ValueError(f"the grid gives (k, n) = {(k, n)}")
        self.src = BinarySource(device=device)
        self.enc = LDPC5GEncoder(k, n, device=device)
        self.il = RowColumnInterleaver(
            row_depth=cfg["interleaver"]["row_depth"], device=device)
        self.dil = Deinterleaver(self.il, device=device)
        self.mapper = Mapper("qam", m, device=device)
        self.rg_mapper = ResourceGridMapper(rg, device=device)
        tdl = TDL(ch["profile"], ch["delay_spread_s"],
                  ch["carrier_frequency_hz"], min_speed=ch["min_speed_m_s"],
                  max_speed=ch["max_speed_m_s"])
        self.channel = OFDMChannel(
            rec.keeping(tdl), rg,
            normalize_channel=ch["normalize_channel"], return_channel=True,
            device=device)
        self.est = LSChannelEstimator(
            rg, interpolation_type=cfg["receiver"]["interpolation"],
            device=device)
        self.equ = LMMSEEqualizer(rg, StreamManagement(np.array([[1]]), 1),
                                  device=device)
        self.demapper = Demapper(cfg["receiver"]["demapping"], "qam", m,
                                 device=device)
        dec = traffic["decoder"]
        layered = dec["cn_schedule"] == "layered"
        self.dec = LDPC5GDecoder(
            self.enc, cn_update=cfg["receiver"]["decoder"]["cn_update"],
            hard_out=True, num_iter=dec["num_iter"],
            cn_schedule=dec["cn_schedule"],
            engine="pallas" if layered else "auto", device=device)

    def __call__(self, batch_size, ebno_db):
        rec = self.rec
        rec.mark("tx")
        no = ebnodb2no(ebno_db, self.nbps, self.rate, self.rg).to(self.dev)
        b = self.src([batch_size, 1, 1, self.k])
        x = self.rg_mapper(self.mapper(self.il(self.enc(b))))
        rec.mark("channel")
        y, h = self.channel(x, no)
        rec.mark("estimation")
        h_hat, err_var = self.est(y, no)
        rec.mark("detection")
        x_hat, no_eff = self.equ(y, h_hat, err_var, no)
        llr = self.dil(self.demapper(x_hat, no_eff))
        rec.mark("decode")
        b_hat = self.dec(llr)
        rec.keep(b=b, x=x, h=h, y=y, llr=llr, b_hat=b_hat)
        return b, b_hat


def build(cfg, traffic, device, rec):
    return Link(cfg, traffic, device, rec)


def reference(cfg, traffic):
    return FlagshipReference(cfg, traffic)


def work(cfg, traffic):
    """Operations and bytes of one decoder launch at the cell's batch, by
    the kernel's short name (``k1`` flooding, ``k3`` layered)."""
    dec = traffic["decoder"]
    layered = dec["cn_schedule"] == "layered"
    ref = FlagshipReference(cfg, traffic)
    name = "k3" if layered else "k1"
    return {name: lifted_bp_work(ref.code, traffic["batch_size"],
                                 dec["num_iter"], layered)}
