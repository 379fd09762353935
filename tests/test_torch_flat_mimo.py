"""The benchmark's coded 4 x 16 MIMO link over Kronecker-correlated flat
fading (``benchmark/configs/flat_mimo_4x16.json``, upstream's
Simple_MIMO_Simulation tutorial) on the port's blocks against its plain
reference (``benchmark/reference/flat_mimo_4x16.py``), on the CPU at the
full widths (4 transmit and 16 receive antennas, 16-QAM, k=512 n=1024,
BG2 Z=64) and batch 8, seeded.

Tolerances, relative to the largest magnitude of the reference's value:
- the correlated draw: CORR_RTOL, float32 products of the port's square
  roots (a single-precision ``eigh``) against float64 ones;
- ``lmmse_equalizer``'s x_hat and no_eff: LMMSE_RTOL, the whitening
  and a 4 x 4 Cholesky solve in float32 against complex128 (channels of
  condition number up to about 20 at these correlations);
- the APP LLRs on the port's own x_hat and no_eff: DEMAP_RTOL, a
  float32 log-sum-exp; end to end from y and h: LLR_RTOL, which the
  LLRs' division by small no_eff widens from LMMSE_RTOL;
- the encoder's bits and BP-20's decisions: identical.
The same LMMSE in bfloat16 (the reference rounded at every step) misses
LMMSE_RTOL by three orders of magnitude.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from sionna_tpu_torch.phy import Demapper, Mapper
from sionna_tpu_torch.phy.channel import KroneckerModel
from sionna_tpu_torch.phy.channel.utils import exp_corr_mat
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.mimo import lmmse_equalizer
from sionna_tpu_torch.phy.utils import ebnodb2no

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.append(str(ROOT / "benchmark"))

from reference import ofdm  # noqa: E402
from reference.compare import bf16  # noqa: E402
from reference.flat_mimo_4x16 import (FlatMimoReference,  # noqa: E402
                                      whitened_lmmse)
from reference.ldpc5g import Code  # noqa: E402

torch.set_num_threads(2)

CFG = json.loads((ROOT / "benchmark" / "configs"
                  / "flat_mimo_4x16.json").read_text())
EBNO_DB = 3.5
BATCH = 8
CORR_RTOL = 2e-6
LMMSE_RTOL = 4e-5
DEMAP_RTOL = 1e-6
LLR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _gap(program, reference):
    """Widest gap over the reference's largest magnitude."""
    return float((program.to(reference.dtype) - reference).abs().max()
                 / reference.abs().max())


@pytest.fixture(scope="module")
def link():
    """One seeded pass of the link at batch 8 on the port's blocks: the
    tensors between the stages, and the reference."""
    g = torch.Generator().manual_seed(2024)
    nt, nr, k, n = 4, 16, 512, 1024
    enc = LDPC5GEncoder(k, n, device="cpu")
    b = torch.randint(0, 2, (BATCH, nt, k), generator=g).float()
    x = Mapper("qam", 4, device="cpu")(enc(b))
    ch = CFG["channel"]
    kron = KroneckerModel(exp_corr_mat(ch["tx_exp_corr"], nt, device="cpu"),
                          exp_corr_mat(ch["rx_exp_corr"], nr, device="cpu"))
    shape = (BATCH * n // 4, nr, nt)
    h_iid = torch.complex(torch.randn(shape, generator=g),
                          torch.randn(shape, generator=g)) * 0.5 ** 0.5
    h = kron(h_iid)
    no = ebnodb2no(EBNO_DB, 4, k / n) * nr ** 0.5
    y = (h @ x.reshape(-1, nt)[..., None])[..., 0]
    y = y + torch.complex(torch.randn(y.shape, generator=g),
                          torch.randn(y.shape, generator=g)) \
        * (float(no) / 2) ** 0.5
    x_hat, no_eff = lmmse_equalizer(y, h,
                                    (no * torch.eye(nr)).to(torch.complex64))
    llr = Demapper("app", "qam", 4, device="cpu")(
        x_hat.reshape(x.shape), no_eff.reshape(x.shape))
    return {"enc": enc, "b": b, "x": x, "h_iid": h_iid, "h": h, "y": y,
            "x_hat": x_hat, "no_eff": no_eff, "llr": llr,
            "ref": FlatMimoReference(CFG, {"ebno_db": EBNO_DB})}


@pytest.mark.parametrize("stage", ["draw", "x_hat", "no_eff", "demap",
                                   "llr"])
def test_stage_against_the_reference(link, stage):
    ref = link["ref"]
    c128 = torch.complex128
    y, h = link["y"].to(c128), link["h"].to(c128)
    if stage == "draw":
        got, want, tol = link["h"], ref.channel(link["h_iid"]), CORR_RTOL
    elif stage in ("x_hat", "no_eff"):
        want = dict(zip(("x_hat", "no_eff"), whitened_lmmse(y, h, ref.no)))
        got, want, tol = link[stage], want[stage], LMMSE_RTOL
    elif stage == "demap":
        shape = link["x"].shape
        got, tol = link["llr"], DEMAP_RTOL
        want = ofdm.app_demap(link["x_hat"].reshape(shape).to(c128),
                              link["no_eff"].reshape(shape).double(), 4)
    else:
        got, want, tol = link["llr"], ref.receive(y, h), LLR_RTOL
    assert got.shape == want.shape
    assert _gap(got, want) < tol


def test_bf16_lmmse_fails_the_tolerance(link):
    """The reference's LMMSE rounded to bfloat16 at every step, on the
    same y and h: its x_hat and no_eff miss LMMSE_RTOL."""
    ref = link["ref"]
    y, h = link["y"].to(torch.complex128), link["h"].to(torch.complex128)
    exact = whitened_lmmse(y, h, ref.no)
    low = whitened_lmmse(bf16(y), bf16(h), ref.no, q=bf16)
    assert min(_gap(a, e) for a, e in zip(low, exact)) > 100 * LMMSE_RTOL


def test_bg2_encoder_and_bp20_decoder_bit_for_bit(link):
    """The BG2 Z=64 code: the port's encoder against the plain one, bit
    for bit, and the port's BP-20 (the configuration's check-node rule,
    hard decisions) on the link's LLRs against the plain flooding
    decoder, decision for decision (some of the 32 words fail at this
    Eb/No)."""
    ref, enc = link["ref"], link["enc"]
    code = Code(512, 1024)
    assert (code.bg, code.z) == (2, 64)
    u = link["b"].reshape(-1, 512)
    c = code.encode(u)
    assert int(code.syndrome_weight(c).max()) == 0
    assert torch.equal(code.rate_match(c), enc(u).long())
    dec_cfg = CFG["receiver"]["decoder"]
    dec = LDPC5GDecoder(enc, cn_update=dec_cfg["cn_update"],
                        hard_out=dec_cfg["hard_out"],
                        num_iter=dec_cfg["num_iter"], device="cpu")
    got = dec(link["llr"]).reshape(-1, 512).long()
    want = ref.decode(link["llr"])
    assert torch.equal(got, want)
    wrong = (want != u.long()).any(1)
    assert 0 < int(wrong.sum()) < want.shape[0]
