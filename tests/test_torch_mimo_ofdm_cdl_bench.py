"""The benchmark's 4 x 4 MIMO-OFDM uplink over CDL-B (BASELINE config 3,
``benchmark/configs/mimo_ofdm_cdl.json``), as its configuration module
``benchmark/configs/mimo_ofdm_cdl.py`` builds it from the port's blocks,
against its plain reference (``benchmark/reference/mimo_ofdm_cdl.py``),
on the CPU at the full widths (a 14 x 128 grid, 4 streams, 4 x 4
cross-polarized arrays, 16-QAM, k=3072 n=6144, BG2 Z=320) and batch 2,
seeded; the work count of its min-sum decoder; and the span of the CDL
draw.

Tolerances, relative to the largest magnitude of the reference's value:
- the grid: TX_RTOL, the complex64 constellation points and pilots
  against complex128 ones (one rounding, 2^-24 relative);
- the frequency response from (a, tau): CHANNEL_RTOL, float32 phases
  2 pi f tau and a float32 sum over the 23 clusters and the
  normalization against float64;
- the LS "lin" estimate and its error variance on the port's own y:
  EST_RTOL, a complex64 division at the pilots and at most four float32
  taps a resource element;
- the LLRs end to end from y: LLR_RTOL, which the per-RE 4 x 4 LMMSE's
  division by diag(G H) and the APP demapper's division by small no_eff
  widen from EST_RTOL;
- the encoder's bits and min-sum BP-12's decisions: identical.
The same link in bfloat16 (the reference rounded at every step) misses
TX_RTOL, CHANNEL_RTOL and LLR_RTOL.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.utils import Profiler, ebnodb2no
from sionna_tpu_torch.phy.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.append(str(ROOT / "benchmark"))

import harness  # noqa: E402
from reference.compare import bf16  # noqa: E402
from reference.mimo_ofdm_cdl import (MimoOfdmCdlReference,  # noqa: E402
                                     MinSumCode, minsum_work)

torch.set_num_threads(2)

CFG = json.loads((ROOT / "benchmark" / "configs"
                  / "mimo_ofdm_cdl.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark" / "workloads"
                      / "mimo_ofdm_cdl.minsum_bp12.json").read_text())
EBNO_DB = 8.0
BATCH = 2
TX_RTOL = 1e-6
CHANNEL_RTOL = 2e-5
EST_RTOL = 1e-5
LLR_RTOL = 2e-4


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


def _build():
    """The benchmark's own link (``benchmark/configs/mimo_ofdm_cdl.py``)
    on the CPU, its recorder armed, so that it keeps what the harness
    compares: b, x, h, y, llr, b_hat and the CDL's draw (a, tau)."""
    mod = harness.load_module(ROOT / "benchmark" / "configs"
                              / "mimo_ofdm_cdl.py", "bench_config_cdl")
    rec = harness.Recorder()
    rec.slot = {}
    return mod, mod.build(CFG, TRAFFIC, "cpu", rec), rec.slot


@pytest.fixture(scope="module")
def link():
    """One seeded MC iteration of the benchmark's link at batch 2: the
    tensors it keeps, its LS estimate of the kept y, and the
    reference."""
    torch_config.seed = 2026
    _, net, kept = _build()
    net(BATCH, EBNO_DB)
    no = ebnodb2no(EBNO_DB, net.nbps, net.rate, net.rg)
    h_hat, err_var = net.est(kept["y"], no)
    return {**kept, "net": net, "h_hat": h_hat, "err_var": err_var,
            "ref": MimoOfdmCdlReference(CFG, {"ebno_db": EBNO_DB})}


def _c128(link, name, *shape):
    return link[name].reshape(BATCH, *shape).to(torch.complex128)


@pytest.mark.parametrize("stage", ["grid", "channel", "h_hat", "err_var",
                                   "llr"])
def test_stage_against_the_reference(link, stage):
    ref = link["ref"]
    y = _c128(link, "y", 4, -1)
    if stage == "grid":
        got, want, tol = link["x"], ref.transmit(link["b"]), TX_RTOL
        got = got.reshape(want.shape)
    elif stage == "channel":
        got, tol = link["h"], CHANNEL_RTOL
        want = ref.channel(link["a"], link["tau"])
        got = got[:, 0, :, 0].reshape(want.shape)
    elif stage in ("h_hat", "err_var"):
        h_ref, ev_ref = ref.estimate(y)
        tol = EST_RTOL
        if stage == "h_hat":
            # [B, 1, rxa, 1, S, T, F] -> [B, rxa, S, T * F]
            got, want = link["h_hat"][:, 0, :, 0], h_ref
        else:
            got, want = link["err_var"][0, 0, 0, 0], ev_ref
        got = got.reshape(want.shape)
    else:
        got, want, tol = link["llr"], ref.receive(y), LLR_RTOL
        got = got.reshape(want.shape)
    assert _gap(got, want) < tol


def test_bf16_reference_misses_the_tolerances(link):
    """The reference rounded to bfloat16 at every step, on the same bits,
    draw and noise: its grid, frequency response and LLRs miss TX_RTOL,
    CHANNEL_RTOL and LLR_RTOL."""
    ref = link["ref"]
    b, a, tau = link["b"], link["a"], link["tau"]
    x, h = ref.transmit(b), ref.channel(a, tau)
    y = _c128(link, "y", 4, -1)
    xq, hq = ref.transmit(b, bf16), ref.channel(a, tau, bf16)
    through = MimoOfdmCdlReference._through
    noise = y - through(_c128(link, "h", 4, 4, -1), _c128(link, "x", 4, -1))
    y_exact = through(h, x) + noise
    y_low = bf16(bf16(through(hq, xq)) + noise)
    assert _gap(xq, x) > 10 * TX_RTOL
    assert _gap(hq, h) > 10 * CHANNEL_RTOL
    assert _gap(ref.receive(y_low, bf16), ref.receive(y_exact)) \
        > 10 * LLR_RTOL


def test_encoder_and_minsum_bp12_bit_for_bit(link):
    """The BG2 Z=320 code: the link's encoder against the plain one, bit
    for bit; the link's decoder (the port's plain min-sum BP-12 on the
    CPU) against the reference's ``MinSumCode``, decision for decision,
    on the link's own LLRs and decisions and on 16 words at a noise
    where about half of them fail."""
    ref, net = link["ref"], link["net"]
    enc, dec = net.enc, net.dec
    code = ref.code
    assert (code.bg, code.z) == (2, 320)
    assert (dec._cn_update_name, dec.num_iter) == ("minsum", 12)
    u = link["b"].reshape(-1, code.k)
    c = code.encode(u)
    assert int(code.syndrome_weight(c).max()) == 0
    assert torch.equal(code.rate_match(c), enc(u).long())
    got = link["b_hat"].reshape(-1, code.k).long()
    assert torch.equal(got, ref.decode(link["llr"]))
    g = torch.Generator().manual_seed(26)
    u = torch.randint(0, 2, (16, code.k), generator=g).float()
    sent = enc(u)
    llr = -((1 - 2 * sent) * 2.0
            + 1.57 * torch.randn(sent.shape, generator=g))
    got = dec(llr).long()
    want = ref.decode(llr)
    assert torch.equal(got, want)
    wrong = int((want != u.long()).any(1).sum())
    assert 3 <= wrong <= 13


def test_minsum_rule_is_the_least_other_magnitude():
    """``MinSumCode``'s check node on a hand-made row: each edge gets the
    product of the other signs times the least other magnitude, clipped
    at llr_max; a pad (+inf) is never the least."""
    code = MinSumCode(3072, 6144, llr_max=20.0)
    v2c = torch.tensor([[-3.0], [0.5], [7.0], [float("inf")],
                        [-25.0]])[:, :, None]
    pad = torch.tensor([False, False, False, True, False])[:, None, None]
    got = code._cn_update(v2c, pad, torch.float32)[:, 0, 0]
    want = torch.tensor([-0.5, 3.0, 0.5, 0.5, -0.5])
    assert torch.equal(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]])
    big = torch.full((3, 1, 1), 30.0)
    assert torch.equal(code._cn_update(big, pad[:3], torch.float32),
                       torch.full((3, 1, 1), 20.0))


def test_minsum_work_pins_config_3():
    """The min-sum count of one K1 launch at config 3's code, 2,048
    codewords (512 grids of 4 streams), 12 iterations: (11 + 4) E + 2 N
    operations an iteration, 8 bytes a variable node and codeword; the
    configuration module hands the harness the count of the cell's batch
    (4 codewords a grid) as ``k1``."""
    code = MinSumCode(3072, 6144)
    assert (code.num_edges, code.num_vns) == (24000, 6912)
    w = minsum_work(code, 2048, 12)
    assert w == {"flops": 9_187_098_624.0, "bytes": 113_246_208.0}
    mod = harness.load_module(ROOT / "benchmark" / "configs"
                              / "mimo_ofdm_cdl.py", "bench_config_cdl")
    assert mod.work(CFG, TRAFFIC) == {"k1": minsum_work(
        code, 4 * TRAFFIC["batch_size"], 12)}


def test_cdl_draw_is_a_span_inside_ofdm_channel():
    """Under an active ``Profiler`` one channel call opens one ``CDL``
    span, inside the ``OFDMChannel`` span; with none active the draw
    records nothing."""
    channel = _build()[1].channel
    x = torch.zeros((1, 1, 4, 14, 128), dtype=torch.complex64)
    with Profiler() as prof:
        channel(x, torch.tensor(0.1))
    spans = prof.spans()
    cdl = [s for s in spans if s.name == "CDL"]
    assert len(cdl) == 1 and cdl[0].end_ns is not None
    outer = [i for i, s in enumerate(spans) if s.name == "OFDMChannel"]
    assert len(outer) == 1
    parent = cdl[0].parent
    while parent is not None and parent != outer[0]:
        parent = spans[parent].parent
    assert parent == outer[0]
    idle = Profiler()
    assert profiling.active is None
    channel(x, torch.tensor(0.1))
    assert idle.spans() == [] and len(prof.spans()) == len(spans)
