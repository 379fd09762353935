"""The 5G NR PUSCH link of ``pusch_273prb.json``, built from
``sionna_tpu_torch``'s public blocks as upstream's PUSCH tutorial
composes it, and its reference (``reference/pusch_273prb.py``).

The receiver's channel estimator, detector and TB decoder are built here
and handed to ``PUSCHReceiver``, so the layers' marks are forward
pre-hooks on blocks of the harness's own making."""

import numpy as np

from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import CDL, AntennaArray
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.nr import (PUSCHConfig, PUSCHLSChannelEstimator,
                                     PUSCHReceiver, PUSCHTransmitter,
                                     TBDecoder, TBEncoder)
from sionna_tpu_torch.phy.ofdm import LinearDetector
from sionna_tpu_torch.phy.utils import ebnodb2no

from reference.pusch_273prb import PuschReference
from reference.work import lifted_bp_work


def pusch_config(cfg):
    """The ``PUSCHConfig`` the configuration states."""
    pc = PUSCHConfig()
    pc.carrier.subcarrier_spacing = cfg["carrier"]["subcarrier_spacing_khz"]
    pc.carrier.n_size_grid = cfg["carrier"]["n_size_grid"]
    pc.carrier.n_cell_id = cfg["n_cell_id"]
    pc.carrier.slot_number = cfg["slot_number"]
    pc.n_rnti = cfg["n_rnti"]
    pc.num_antenna_ports = cfg["num_antenna_ports"]
    pc.num_layers = cfg["num_layers"]
    pc.precoding = cfg["precoding"]
    pc.tpmi = cfg["tpmi"]
    for key, value in cfg["dmrs"].items():
        setattr(pc.dmrs, key, value)
    pc.tb.mcs_index = cfg["tb"]["mcs_index"]
    pc.tb.mcs_table = cfg["tb"]["mcs_table"]
    return pc


class Link:
    """One MC iteration of the PUSCH link (the ``sim_ber`` model)."""

    def __init__(self, cfg, traffic, device, rec):
        self.rec, self.dev = rec, device
        pc = pusch_config(cfg)
        self.nbps = pc.tb.num_bits_per_symbol
        self.rate = pc.tb.target_coderate
        self.tx = PUSCHTransmitter(pc, device=device)
        self.rg = rg = self.tx.resource_grid
        ch = cfg["channel"]
        fc = ch["carrier_frequency_hz"]
        ue = AntennaArray(carrier_frequency=fc, **ch["ue_array"])
        bs = AntennaArray(carrier_frequency=fc, **ch["bs_array"])
        cdl = CDL(ch["profile"], ch["delay_spread_s"], fc, ue, bs,
                  ch["direction"], min_speed=ch["min_speed_m_s"],
                  device=device)
        self.channel = OFDMChannel(
            rec.keeping(cdl), rg, normalize_channel=ch["normalize_channel"],
            return_channel=True, device=device)
        self.perfect = traffic["receiver"] == "perfect_csi"
        est = None if self.perfect else PUSCHLSChannelEstimator(
            rg, pc.dmrs.length, pc.dmrs.additional_position,
            pc.dmrs.num_cdm_groups_without_data,
            interpolation_type=cfg["receiver"]["interpolation"],
            device=device)
        det = LinearDetector(
            cfg["receiver"]["detector"], "bit", cfg["receiver"]["demapping"],
            rg, StreamManagement(np.ones([1, 1], bool), pc.num_layers),
            "qam", self.nbps, device=device)
        n_id = pc.carrier.n_cell_id if pc.tb.n_id is None else pc.tb.n_id
        enc = TBEncoder(pc.tb_size, pc.num_coded_bits, self.rate, self.nbps,
                        num_layers=pc.num_layers, n_rnti=pc.n_rnti,
                        n_id=n_id, channel_type="PUSCH", device=device)
        dec = cfg["receiver"]["decoder"]
        self.tb_decoder = tbd = TBDecoder(
            enc, num_bp_iter=dec["num_iter"], cn_update=dec["cn_update"],
            device=device)
        self.rx = PUSCHReceiver(
            self.tx, channel_estimator="perfect" if self.perfect else est,
            mimo_detector=det, tb_decoder=tbd, device=device)
        if est is not None:
            est.register_forward_pre_hook(
                lambda m, args: rec.mark("estimation"))
        det.register_forward_pre_hook(lambda m, args: rec.mark("detection"))
        tbd.register_forward_pre_hook(self._decoder_input)

    def _decoder_input(self, module, args):
        self.rec.mark("decode")
        self.rec.keep(llr=args[0])

    def __call__(self, batch_size, ebno_db):
        rec = self.rec
        rec.mark("tx")
        no = ebnodb2no(ebno_db, self.nbps, self.rate, self.rg).to(self.dev)
        x, b = self.tx(int(batch_size))
        rec.mark("channel")
        y, h = self.channel(x, no)
        b_hat = self.rx(y, no, h) if self.perfect else self.rx(y, no)
        rec.keep(b=b, x=x, h=h, y=y, b_hat=b_hat)
        return b, b_hat


def build(cfg, traffic, device, rec):
    return Link(cfg, traffic, device, rec)


def reference(cfg, traffic):
    return PuschReference(cfg, traffic)


def work(cfg, traffic):
    """Operations and bytes of one K1 launch (every code block of the
    batch's transport blocks in one call)."""
    ref = PuschReference(cfg, traffic)
    return {"k1": lifted_bp_work(ref.code, traffic["batch_size"] * ref.c,
                                 cfg["receiver"]["decoder"]["num_iter"],
                                 layered=False)}
