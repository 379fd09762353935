"""The port's first slice as a whole: the coded-AWGN 5G-LDPC link against
the JAX package on the same bits and noise; the port's ``sim_ber``
against closed-form BER, and against JAX's signature, checkpoints and
profiler phases; the ``Profiler``."""

import time

import numpy as np
import pytest
import torch
from scipy.special import erfc

import jax
import jax.numpy as jnp

import sionna_tpu.phy.mapping as jmap
import sionna_tpu.phy.utils as jutils
from sionna_tpu.phy.fec.ldpc import LDPC5GEncoder as JEnc
from sionna_tpu.phy.fec.ldpc import LDPC5GDecoder as JDec
from sionna_tpu_torch.phy import AWGN, BinarySource, Demapper, Mapper
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GDecoder, LDPC5GEncoder
from sionna_tpu_torch.phy.utils import (Profiler, ebnodb2no, hard_decisions,
                                       sim_ber)
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device

# Demapper LLRs: logsumexp over 16 points (port) against per-axis
# pairwise logaddexp (JAX), both f32: a few ULP of |LLR| <= ~40.
LLR_ATOL = 1e-4
# Decoder marginals from the same LLRs: XLA:CPU's f32 tanh/log1p differ
# from libm's by a few ULP per CN update, and near saturation the
# boxplus rule amplifies that by 1/(1 - tanh): measured 5e-5 after 1
# iteration, 6e-5 after 3, 4e-4 after 5 and 0.16 (at |marginal| ~16)
# after 10. The marginals are held after 3 iterations; after 10, the
# decisions and error counts must be identical.
MARG_ATOL = 1e-4


def test_coded_link_matches_jax():
    k, n, nbps, batch, ebno_db = 512, 1024, 4, 16, 4.0
    rng = np.random.default_rng(0)
    b = rng.integers(0, 2, (batch, k)).astype(np.float32)
    # noise scaled as the AWGN block scales it: sqrt(no/2) per part,
    # with one f32 no for both packages
    no = np.float32(1 / (10 ** (ebno_db / 10) * (k / n) * nbps))
    noise = ((rng.normal(size=(batch, n // nbps))
              + 1j * rng.normal(size=(batch, n // nbps)))
             * np.sqrt(no / 2)).astype(np.complex64)

    te = LDPC5GEncoder(k, n, num_bits_per_symbol=nbps)
    tmap, tdem = Mapper("qam", nbps), Demapper("app", "qam", nbps)
    tdec = LDPC5GDecoder(te, num_iter=10, hard_out=False)
    je = JEnc(k, n, num_bits_per_symbol=nbps)
    jmapper, jdem = jmap.Mapper("qam", nbps), jmap.Demapper("app", "qam", nbps)

    tb = torch.as_tensor(b)
    tc = te(tb)
    tx = tmap(tc)
    ty = tx + torch.as_tensor(noise)
    tllr = tdem(ty, torch.tensor(no))
    tsoft = tdec(tllr)

    @jax.jit
    def jax_link(b, noise):
        y = jmapper(je(b)) + noise
        llr = jdem(y, no)
        return je(b), y, llr

    jc, jy, jllr = jax_link(jnp.asarray(b), jnp.asarray(noise))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tllr.numpy(), np.asarray(jllr), rtol=0,
                               atol=LLR_ATOL)
    # decoder alone on JAX's LLRs (JAX's lifted engine: the Pallas
    # kernel in interpret mode is too slow at this size on the CPU)
    jdec = JDec(je, num_iter=10, hard_out=False, engine="lifted")
    jsoft, jsoft3 = (np.asarray(x) for x in jax.jit(
        lambda x: (jdec(x), jdec(x, num_iter=3)))(jllr))
    np.testing.assert_allclose(
        tdec(torch.as_tensor(np.array(jllr)), num_iter=3).numpy(), jsoft3,
        rtol=0, atol=MARG_ATOL)
    # the whole chain: identical decisions and error counts
    t_hat = hard_decisions(tsoft).numpy()
    j_hat = (jsoft > 0).astype(np.float32)  # JAX's hard_out is this
    np.testing.assert_array_equal(t_hat, j_hat)
    assert int((t_hat != b).sum()) == int((j_hat != b).sum())
    assert int((t_hat != b).any(-1).sum()) == int((j_hat != b).any(-1).sum())


def _uncoded_model(nbps):
    src, mapper = BinarySource(), Mapper("qam", nbps)
    demapper, awgn = Demapper("app", "qam", nbps), AWGN()

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, nbps, 1.0)
        b = src([batch_size, 1024])
        llr = demapper(awgn(mapper(b), no), no)
        return b, hard_decisions(llr)

    return mc_fun


def test_sim_ber_qpsk_matches_theory():
    ebno_dbs = np.array([0.0, 2.0, 4.0])
    ber, bler = sim_ber(_uncoded_model(2), ebno_dbs, batch_size=256,
                        max_mc_iter=8, early_stop=False, verbose=False)
    assert ber.dtype == torch.float64 and ber.shape == (3,)
    theory = 0.5 * erfc(np.sqrt(10 ** (ebno_dbs / 10)))
    np.testing.assert_allclose(ber.numpy(), theory, rtol=0.15)
    assert np.all(bler.numpy() > 0)


def test_sim_ber_16qam_matches_theory():
    ber, _ = sim_ber(_uncoded_model(4), [4.0], batch_size=512,
                     max_mc_iter=8, early_stop=False, verbose=False)
    theory = 3 / 8 * erfc(np.sqrt(4 * 10 ** 0.4 / 10))
    assert float(ber[0]) == pytest.approx(theory, rel=0.2)


def test_sim_ber_stopping_rules(capsys):
    mc_fun = _uncoded_model(2)
    # no errors at high SNR: the sweep stops, later points not simulated
    ber, bler = sim_ber(mc_fun, [20.0, 21.0, 22.0], batch_size=64,
                        max_mc_iter=2, early_stop=True, verbose=True)
    assert float(ber[0]) == 0.0 and np.isnan(ber.numpy()[1:]).all()
    out = capsys.readouterr().out
    assert "EbNo [dB]" in out and "Simulation stopped" in out
    # target block errors end the point before max_mc_iter
    calls = []

    def counted(batch_size, ebno_db):
        calls.append(ebno_db)
        return mc_fun(batch_size, ebno_db)

    ber, bler = sim_ber(counted, [0.0], batch_size=64, max_mc_iter=100,
                        num_target_block_errors=10, device_iters=1,
                        verbose=False)
    assert float(ber[0]) > 0 and len(calls) < 100
    calls.clear()
    sim_ber(counted, [0.0], batch_size=64, max_mc_iter=100,
            num_target_bit_errors=500, device_iters=2, verbose=False)
    assert len(calls) < 100 and len(calls) % 2 == 0
    # a target BER/BLER stops the sweep after the point that reaches it
    ber, _ = sim_ber(mc_fun, [8.0, 9.0], batch_size=64, max_mc_iter=2,
                     target_ber=1e-2, early_stop=False, verbose=False)
    assert np.isnan(float(ber[1]))
    ber, _ = sim_ber(mc_fun, [8.0, 9.0], batch_size=64, max_mc_iter=2,
                     target_bler=0.9, early_stop=False, verbose=False)
    assert np.isnan(float(ber[1]))
    # a callback returning True ends the point; it sees the counters
    seen = []

    def callback(it, i, ebno, bit_e, blk_e, nb, nblk):
        seen.append((it, int(nb[i])))
        return True

    sim_ber(mc_fun, [0.0], batch_size=64, max_mc_iter=10, device_iters=1,
            callback=callback, verbose=False)
    assert seen == [(1, 64 * 1024)]

    # an interrupt ends the sweep: points never simulated read -1
    def interrupted(batch_size, ebno_db):
        if ebno_db > 1.0:
            raise KeyboardInterrupt
        return mc_fun(batch_size, ebno_db)

    ber, bler = sim_ber(interrupted, [0.0, 2.0], batch_size=64,
                        max_mc_iter=1, forward_keyboard_interrupt=False,
                        verbose=False)
    assert float(ber[0]) > 0 and float(ber[1]) == -1.0
    with pytest.raises(KeyboardInterrupt):
        sim_ber(interrupted, [2.0], batch_size=64, max_mc_iter=1,
                verbose=False)
    # soft estimates are hard-decided by sim_ber
    ber_soft, _ = sim_ber(lambda bs, e: (torch.zeros(bs, 8),
                                         torch.full((bs, 8), -1.0)),
                          [1.0], batch_size=4, max_mc_iter=2,
                          soft_estimates=True, verbose=False)
    assert float(ber_soft[0]) == 0.0
    # distribute="all" without a torch.distributed group and with one
    # visible device is this process alone, as None (and as JAX's "all"
    # on one device); a JAX-style device list has no counterpart
    ones = lambda bs, e: (torch.zeros(bs, 8), torch.ones(bs, 8))
    for distribute in (None, "all"):
        ber_all, _ = sim_ber(ones, [0.0], 8, 2, distribute=distribute,
                             verbose=False)
        assert float(ber_all[0]) == 1.0
    with pytest.raises(ValueError, match="torchrun"):
        sim_ber(mc_fun, [0.0], 8, 1, distribute=["cpu"])


def _zeros_mc_fun(batch_size, ebno_db):
    return torch.zeros(4, 8), torch.zeros(4, 8)


@pytest.mark.parametrize("kw", [{"graph_mode": "xla"},
                                {"graph_mode": "graph"},
                                {"graph_mode": None},
                                {"precision": "single"},
                                {"precision": "double"},
                                {"profiler": None}])
def test_sim_ber_accepts_jax_keywords(kw):
    """Fault F1: the reference's graph_mode, precision and profiler
    keywords are accepted (they raised TypeError before), with JAX's
    result on the same model."""
    ber, bler = sim_ber(_zeros_mc_fun, [0.0], 4, 2, verbose=False, **kw)
    jber, jbler = jutils.sim_ber(lambda bs, e: (jnp.zeros((4, 8)),
                                                jnp.zeros((4, 8))),
                                 [0.0], 4, 2, verbose=False, **kw)
    np.testing.assert_array_equal(ber.numpy(), np.asarray(jber))
    np.testing.assert_array_equal(bler.numpy(), np.asarray(jbler))
    assert ber.tolist() == [0.0] and bler.tolist() == [0.0]


def test_sim_ber_validates_keywords():
    for kw in ({"graph_mode": "eager"}, {"precision": "half"}):
        with pytest.raises(ValueError):
            sim_ber(_zeros_mc_fun, [0.0], 4, 2, verbose=False, **kw)
        with pytest.raises(ValueError):
            jutils.sim_ber(_zeros_mc_fun, [0.0], 4, 2, verbose=False, **kw)


def test_sim_ber_checkpoint_resume(tmp_path):
    """As tests/test_awgn_sim.py holds JAX's: the counters are saved
    after every chunk; a point marked half-done resumes from its
    iteration count; a completed sweep resumes without a call; an
    unreadable or mismatching file means a fresh start."""
    mc_fun = _uncoded_model(2)
    calls = []

    def counted(batch_size, ebno_db):
        calls.append(ebno_db)
        return mc_fun(batch_size, ebno_db)

    ck = str(tmp_path / "sweep.npz")
    ber1, bler1 = sim_ber(counted, [0., 3.], 100, max_mc_iter=4,
                          device_iters=2, early_stop=False, verbose=False,
                          checkpoint_path=ck)
    assert len(calls) == 8
    st = dict(np.load(ck, allow_pickle=True))
    assert list(st["status"]) == ["reached max iter"] * 2
    assert list(st["iters"]) == [4, 4]
    assert list(st["nb_bits"]) == [4 * 100 * 1024] * 2
    # a complete sweep resumes as complete: no call, the same numbers
    calls.clear()
    ber2, bler2 = sim_ber(counted, [0., 3.], 100, max_mc_iter=4,
                          early_stop=False, verbose=False,
                          checkpoint_path=ck)
    assert calls == []
    assert torch.equal(ber2, ber1) and torch.equal(bler2, bler1)
    # mark point 1 half-done and resume: two more iterations there
    status = st["status"].copy()
    status[1] = ""
    iters = st["iters"].copy()
    iters[1] = 2
    np.savez(ck, ebno_dbs=st["ebno_dbs"], bit_errors=st["bit_errors"],
             block_errors=st["block_errors"], nb_bits=st["nb_bits"],
             nb_blocks=st["nb_blocks"], iters=iters, status=status)
    sim_ber(counted, [0., 3.], 100, max_mc_iter=4, early_stop=False,
            verbose=False, checkpoint_path=ck)
    assert calls == [3.0, 3.0]
    st2 = np.load(ck, allow_pickle=True)
    assert list(st2["iters"]) == [4, 4]
    assert int(st2["nb_bits"][1]) == 6 * 100 * 1024
    # another sweep, or an unreadable file: a fresh start
    calls.clear()
    sim_ber(counted, [1.0], 100, max_mc_iter=1, verbose=False,
            checkpoint_path=ck)
    assert calls == [1.0]
    with open(ck, "wb") as f:
        f.write(b"not an npz")
    calls.clear()
    sim_ber(counted, [1.0], 100, max_mc_iter=1, verbose=False,
            checkpoint_path=ck)
    assert calls == [1.0]
    assert not (tmp_path / "sweep.npz.tmp.npz").exists()


def test_sim_ber_interrupt_marks_points(tmp_path):
    """A KeyboardInterrupt marks the unfinished points "interrupted" and
    saves the checkpoint before the re-raise; resuming finishes them."""
    mc_fun = _uncoded_model(2)

    def interrupted(batch_size, ebno_db):
        if ebno_db > 1.0:
            raise KeyboardInterrupt
        return mc_fun(batch_size, ebno_db)

    ck = str(tmp_path / "sweep.npz")
    with pytest.raises(KeyboardInterrupt):
        sim_ber(interrupted, [0.0, 2.0, 3.0], 64, max_mc_iter=2,
                early_stop=False, verbose=False, checkpoint_path=ck)
    st = np.load(ck, allow_pickle=True)
    assert list(st["status"]) == ["reached max iter", "interrupted",
                                  "interrupted"]
    ber, _ = sim_ber(interrupted, [0.0, 2.0, 3.0], 64, max_mc_iter=2,
                     early_stop=False, verbose=False,
                     forward_keyboard_interrupt=False, checkpoint_path=ck)
    assert float(ber[0]) > 0 and ber[1:].tolist() == [-1.0, -1.0]
    calls = []
    sim_ber(lambda bs, e: calls.append(e) or mc_fun(bs, e),
            [0.0, 2.0, 3.0], 64, max_mc_iter=2, early_stop=False,
            verbose=False, checkpoint_path=ck)
    assert calls == [2.0, 2.0, 3.0, 3.0]
    st = np.load(ck, allow_pickle=True)
    assert list(st["status"]) == ["reached max iter"] * 3


def test_profiler_phases(tmp_path):
    """As tests/test_utils.py holds JAX's Profiler; a ``torch.profiler``
    trace taken around an active Profiler holds the phase."""
    prof = Profiler()
    with prof.phase("a"):
        time.sleep(0.01)
    with prof.phase("a"):
        time.sleep(0.01)
    with prof.phase("b"):
        with prof.phase("inner"):
            pass
    assert prof.counts["a"] == 2
    assert prof.times["a"] >= 0.02
    assert "inner" in prof.times
    s = prof.summary()
    assert "a" in s and "mean [ms]" in s
    assert prof.as_dict()["b"]["count"] == 1
    prof.reset()
    assert prof.summary() == "(no phases recorded)"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with Profiler() as prof:
            with prof.phase("matmul_phase"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "trace.json"
    tp.export_chrome_trace(str(path))
    assert "matmul_phase" in path.read_text()
    assert prof.counts == {"matmul_phase": 1}


def test_sim_ber_profiler_integration():
    """sim_ber records "compile" (the first chunk of each length) and
    "mc_chunk" phases, as the JAX package's does on the same sweep (the
    port records its MC iterations, readbacks and blocks besides)."""
    tprof, jprof = Profiler(), jutils.Profiler()
    ber, _ = sim_ber(_uncoded_model(2), [0.0, 2.0], batch_size=64,
                     max_mc_iter=4, verbose=False, early_stop=False,
                     profiler=tprof)

    def jmc(batch_size, ebno_db, key):
        b = jax.random.bernoulli(key, 0.5, (batch_size, 16))
        return b.astype(jnp.float32), b.astype(jnp.float32)

    jutils.sim_ber(jmc, [0.0, 2.0], batch_size=64, max_mc_iter=4,
                   verbose=False, early_stop=False, profiler=jprof)
    chunks = ("compile", "mc_chunk")
    assert {k: tprof.counts[k] for k in chunks} == \
        {k: jprof.counts[k] for k in chunks}
    assert tprof.counts["compile"] == 1 and tprof.counts["mc_chunk"] >= 1
    assert np.all(ber.numpy() > 0)
