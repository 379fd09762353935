"""The coded 4 x 16 MIMO link over Kronecker-correlated flat fading of
``flat_mimo_4x16.json``, built from ``sionna_tpu_torch``'s public blocks
as upstream's Simple_MIMO_Simulation tutorial composes it, and its
reference (``reference/flat_mimo_4x16.py``).

The link's MC call marks the start of each layer (``rec.mark``) and
hands the tensors the check compares to the harness (``rec.keep``); the
uncorrelated draw is handed over by the correlation model the channel
calls. Both are no-ops unless the harness arms them."""

import torch

from sionna_tpu_torch.phy import BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.channel import FlatFadingChannel, KroneckerModel
from sionna_tpu_torch.phy.channel.utils import exp_corr_mat
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.mimo import lmmse_equalizer
from sionna_tpu_torch.phy.utils import ebnodb2no

from reference.flat_mimo_4x16 import FlatMimoReference
from reference.ldpc5g import Code
from reference.work import lifted_bp_work


class _KeptDraw:
    """A spatial correlation model that hands each draw it correlates
    (the i.i.d. channel) to a recorder."""

    def __init__(self, model, rec):
        self._model, self._rec = model, rec

    def __call__(self, h):
        self._rec.keep(h_iid=h)
        return self._model(h)


class Link:
    """One MC iteration of the flat-fading MIMO link (the ``sim_ber``
    model): [batch, num_tx, k] info bits and their decisions."""

    def __init__(self, cfg, traffic, device, rec):
        self.rec, self.dev = rec, device
        self.nbps = m = cfg["num_bits_per_symbol"]
        self.num_tx, self.num_rx = cfg["num_tx_ant"], cfg["num_rx_ant"]
        self.k, self.n = cfg["code"]["k"], cfg["code"]["n"]
        ch, dec = cfg["channel"], cfg["receiver"]["decoder"]
        self.src = BinarySource(device=device)
        self.enc = LDPC5GEncoder(self.k, self.n, device=device)
        self.tx = Mapper("qam", m, device=device)
        corr = KroneckerModel(
            exp_corr_mat(ch["tx_exp_corr"], self.num_tx, device=device),
            exp_corr_mat(ch["rx_exp_corr"], self.num_rx, device=device))
        self.channel = FlatFadingChannel(
            self.num_tx, self.num_rx, spatial_corr=_KeptDraw(corr, rec),
            add_awgn=ch["add_awgn"], return_channel=ch["return_channel"],
            device=device)
        self.eye = torch.eye(self.num_rx, device=device)
        self.demapper = Demapper(cfg["receiver"]["demapping"], "qam", m,
                                 device=device)
        self.dec = LDPC5GDecoder(self.enc, cn_update=dec["cn_update"],
                                 hard_out=dec["hard_out"],
                                 num_iter=dec["num_iter"], device=device)

    def __call__(self, batch_size, ebno_db):
        rec = self.rec
        rec.mark("tx")
        no = ebnodb2no(ebno_db, self.nbps, self.k / self.n).to(self.dev) \
            * self.num_rx ** 0.5
        b = self.src([batch_size, self.num_tx, self.k])
        x = self.tx(self.enc(b))
        rec.mark("channel")
        y, h = self.channel(x.reshape(-1, self.num_tx), no)
        rec.mark("detection")
        x_hat, no_eff = lmmse_equalizer(y, h,
                                        (no * self.eye).to(torch.complex64))
        llr = self.demapper(x_hat.reshape(x.shape), no_eff.reshape(x.shape))
        rec.mark("decode")
        b_hat = self.dec(llr)
        rec.keep(b=b, x=x, h=h, y=y, llr=llr, b_hat=b_hat)
        return b, b_hat


def build(cfg, traffic, device, rec):
    return Link(cfg, traffic, device, rec)


def reference(cfg, traffic):
    return FlatMimoReference(cfg, traffic)


def work(cfg, traffic):
    """Operations and bytes of one K1 launch: the batch's num_tx
    codewords per batch element in one call."""
    code = Code(cfg["code"]["k"], cfg["code"]["n"], cfg["code"]["llr_max"])
    return {"k1": lifted_bp_work(
        code, cfg["num_tx_ant"] * traffic["batch_size"],
        cfg["receiver"]["decoder"]["num_iter"], layered=False)}
