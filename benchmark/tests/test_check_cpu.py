"""The check that decides ``correct``, on the CPU at a tiny batch: the
faults a cell can have, planted under the timed path, come out not
correct, and so does the control (the plain reference in bfloat16 put in
the program's place). A cell on one card has no exchange between chips,
so that fault has no case here."""

import json
import time
from pathlib import Path

import pytest
import torch

import harness
from reference.ldpc5g import Code

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIG = {w["name"]: w["config"] for w in SPEC["workloads"]}
TINY = {"batch_size": 2, "device_iters": 1, "capture": 2,
        "trace_chunks": [1, 2]}
# the CPU rehearsals' sizes: the PUSCH at 16 PRBs (its interpolation
# operator is built on the host)
SMALL = {"pusch_273prb": {"carrier": {"n_size_grid": 16}}}


def _decoded(link):
    """The block whose output holds the decoded bits."""
    return link.dec if hasattr(link, "dec") else link.tb_decoder


def _alter(out, fn):
    """``fn`` applied to the tensor of a block's output (the first one of
    a tuple)."""
    if isinstance(out, tuple):
        return (fn(out[0].clone()),) + tuple(out[1:])
    return fn(out.clone())


def _unchanged_state(link):
    # the LDPC decoder hands back its input's decisions: no iteration runs
    dec = link.dec if hasattr(link, "dec") else link.tb_decoder._decoder
    dec.num_iter = 0


def _half_batch(link):
    # half of the batch decoded, the rest copied from it
    def fn(t):
        half = t.shape[0] // 2
        t[t.shape[0] - half:] = t[:half]
        return t
    _decoded(link).register_forward_hook(lambda m, a, out: _alter(out, fn))


def _answer_altered(link):
    # one decided bit flipped where the decoder produces it
    def fn(t):
        t.view(-1)[7] = 1 - t.view(-1)[7]
        return t
    _decoded(link).register_forward_hook(lambda m, a, out: _alter(out, fn))


def _symbol_altered(link):
    # one resource element of the grid turned where it is produced
    def fn(t):
        t.view(-1)[0] = t.view(-1)[0] * 1j
        return t
    block = link.rg_mapper if hasattr(link, "rg_mapper") else link.tx
    block.register_forward_hook(lambda m, a, out: _alter(out, fn))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("plant", [_unchanged_state, _half_batch,
                                   _answer_altered, _symbol_altered])
def test_planted_fault_is_not_correct(cell, plant):
    res, rows = harness.run(cell, 2 ** 31 + 5, 0.2, 0, time.perf_counter(),
                            device="cpu", overrides=dict(TINY), plant=plant,
                            config_overrides=SMALL.get(CONFIG[cell]))
    assert not res["correct"], rows


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    res, rows = harness.run(cell, 2 ** 31 + 9, 0.2, 0, time.perf_counter(),
                            device="cpu", overrides=dict(TINY),
                            control=True,
                            config_overrides=SMALL.get(CONFIG[cell]))
    assert res["correct"], rows
    limits = {k: r["limit"] for k, r in rows.items()}
    assert any(v > limits[k] for k, v in res["control"].items()), \
        res["control"]


@pytest.mark.parametrize("k,n", [(6144, 12288), (200, 400), (1000, 2000)])
@pytest.mark.parametrize("layered", [False, True])
def test_reference_code_agrees_with_the_port(k, n, layered):
    """The plain encoder and decoders against the port's on the CPU, at
    a noise where about half the words fail: identical bits."""
    from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
    g = torch.Generator().manual_seed(k)
    code = Code(k, n)
    enc = LDPC5GEncoder(k, n, device="cpu")
    u = torch.randint(0, 2, (6, k), generator=g).float()
    c = code.encode(u)
    assert int(code.syndrome_weight(c).max()) == 0
    sent = enc(u)
    assert torch.equal(code.rate_match(c), sent.long())
    dec = LDPC5GDecoder(enc, cn_update="boxplus", hard_out=True,
                        cn_schedule="layered" if layered else "flooding",
                        engine="lifted" if layered else "auto",
                        num_iter=10 if layered else 20, device="cpu")
    llr = -((1 - 2 * sent) * 2.0
            + 2.6 * torch.randn(sent.shape, generator=g))
    ch = code.rate_recover(llr)
    assert torch.equal(ch, dec.recover_llrs(llr))
    ref = (code.decode_layered(ch, 10) if layered
           else code.decode_flooding(ch, 20))
    assert torch.equal(ref, dec(llr).long())
