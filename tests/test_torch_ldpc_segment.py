"""The segment and matmul BP engines of the PyTorch port against the JAX
package: the edge-domain update functions, LDPCBPDecoder (flooding,
layered and custom schedules, identity updates, callbacks, return_state
and warm start, bf16 messages, the matmul engine), its gradients against
jax.grad, and LDPC5GDecoder's engine choice and segment path.

Tolerances. Min-sum and offset min-sum use only abs, min, compare, sign
products (integer parities) and sums: bit-exact, because the port adds
the c2v messages into the channel LLRs in edge order, as XLA does once it
folds ``segment_sum(c2v) + llr`` into one scatter inside the jitted
decoder loop. The tanh and phi rules go through XLA:CPU's own f32
tanh/log/exp/atanh, which differ from torch's by a few ULP, and those
differences grow through the iterations: each case states its bound.
XLA:CPU's tanh returns exactly 1 for |x| > 7.905 (Eigen's clamp) where
torch's keeps the last bits, so phi(|v2c|) differs a lot once |v2c|
passes ~15.8; the soft comparisons use LLRs and iteration counts that
stay below that saturation. On a CUDA card the index_add sums are atomic
and unordered, so there (not here) sums with a repeated index may differ
from JAX's by reordering; 5G layers never repeat a VN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.fec.ldpc as jldpc
import sionna_tpu.phy.fec.ldpc.decoding as jdec
from sionna_tpu.phy.fec.utils import load_parity_check_examples
import sionna_tpu_torch.phy.fec.ldpc as tldpc
import sionna_tpu_torch.phy.fec.ldpc.decoding as tdec
from sionna_tpu_torch.phy.fec.ldpc import (LDPC5GDecoder, LDPC5GEncoder,
                                           LDPCBPDecoder)
from sionna_tpu_torch.phy.fec.utils import pcm2gm
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

PCM1 = load_parity_check_examples(1)[0]  # BCH(63,45), check degree <= 24
PCM3 = load_parity_check_examples(3)[0]  # regular (3,6) LDPC, n=100
# Soft marginals through the tanh/phi rules after a few iterations:
# measured up to 1.7e-6 (flooding) and 1.2e-6 (layered) absolute at
# |marginal| <= 20 after 5 iterations; 1e-5 leaves a margin. The 5G
# layered case of the routing test reads 8.6e-6 and states its own bound.
SOFT_ATOL = 1e-5
# The matmul engine sums with matrix products (MKL against XLA's dot):
# measured 3.3e-6 absolute after 5 iterations.
MATMUL_ATOL = 1e-5


def _pcm_5g():
    return jldpc.LDPC5GDecoder(jldpc.LDPC5GEncoder(100, 200),
                               engine="segment").pcm


def _codeword_llrs(pcm, batch, amp, sigma, seed):
    """Random codewords of ``pcm``'s code and their noisy logit LLRs
    (f32): (2c - 1) * amp plus N(0, sigma^2)."""
    gm = pcm2gm(pcm)
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, (batch, gm.shape[0]))
    c = (b @ gm % 2).astype(np.float32)
    llr = (2 * c - 1) * amp + rng.normal(0, sigma, c.shape)
    return c, llr.astype(np.float32)


def _run_both(kw_j, kw_t, llr, pcm=PCM1, call_kw=None):
    """JAX's LDPCBPDecoder (jitted) and the port's on the same LLRs."""
    call_kw = call_kw or {}
    jd = jldpc.LDPCBPDecoder(pcm, **kw_j)
    td = LDPCBPDecoder(pcm, **kw_t)
    want = jax.jit(lambda x: jd(x, **call_kw))(jnp.asarray(llr))
    got = td(torch.as_tensor(llr), **call_kw)
    return got, want, td


@pytest.mark.parametrize("code", ["example1", "5g"])
@pytest.mark.parametrize("fn", ["cn_update_minsum", "cn_update_offset_minsum",
                                "cn_update_tanh", "cn_update_phi",
                                "cn_node_update_identity", "vn_update_sum",
                                "vn_node_update_identity"])
def test_update_functions_match_jax(code, fn):
    """Each update function on random messages [4, E] (a few exactly 0):
    bit-exact except the tanh and phi rules, which agree to 8 ULP of
    their largest output (measured 7.2e-6 at |c2v| <= 17)."""
    pcm = PCM1 if code == "example1" else _pcm_5g()
    td = LDPCBPDecoder(pcm)
    rng = np.random.default_rng(len(fn))
    msg = (rng.normal(size=(4, td.num_edges)) * 4).astype(np.float32)
    msg[0, :5] = 0.0
    if fn.startswith("vn"):
        llr = (rng.normal(size=(4, td.num_vns)) * 3).astype(np.float32)
        idx, num = td._vn_idx, td.num_vns
        args_j = (jnp.asarray(llr), jnp.asarray(idx.astype(np.int32)), num)
        args_t = (torch.as_tensor(llr), td.vn_idx, num)
    else:
        idx, num = td._cn_idx, td.num_cns
        args_j = (jnp.asarray(idx.astype(np.int32)), num)
        args_t = (td.cn_idx, num)
    want = jax.jit(lambda m: getattr(jdec, fn)(m, *args_j, 20.))(
        jnp.asarray(msg))
    got = getattr(tdec, fn)(torch.as_tensor(msg), *args_t, 20.)
    if fn.startswith("vn"):
        (got, got_m), (want, want_m) = got, want
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if fn in ("cn_update_tanh", "cn_update_phi"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=8 * 17 * 2 ** -23 * 8)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cn", ["minsum", "offset-minsum", "boxplus",
                                "boxplus-phi"])
def test_flooding_decoder_matches_jax(cn):
    """Soft output of BP-5 on noisy codewords of BCH(63,45)."""
    _, llr = _codeword_llrs(PCM1, 6, 2.0, 1.5, seed=1)
    kw = dict(cn_update=cn, hard_out=False, num_iter=5)
    got, want, _ = _run_both(kw, kw, llr)
    assert got.shape == llr.shape and got.dtype == torch.float32
    if cn in ("minsum", "offset-minsum"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=SOFT_ATOL)
    hard, want_hard, _ = _run_both(dict(cn_update=cn, num_iter=5),
                                   dict(cn_update=cn, num_iter=5), llr)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(want_hard))


@pytest.mark.parametrize("schedule", ["layered", "custom"])
def test_layered_schedules_match_jax(schedule):
    """One check node per layer ("layered") and a custom partition into
    three layers of unequal size (padded with the dummy edge and node),
    min-sum bit-exact and boxplus-phi within SOFT_ATOL (measured
    1.2e-6), after 4 iterations on the (3,6) code, at LLRs weak enough
    that the unclipped layered posterior stays below tanh saturation."""
    sched = "layered" if schedule == "layered" else [
        np.arange(0, 20), np.arange(20, 45), np.arange(45, 50)]
    _, llr = _codeword_llrs(PCM3, 5, 1.0, 1.2, seed=2)
    for cn in ("minsum", "boxplus-phi"):
        kw = dict(cn_update=cn, cn_schedule=sched, hard_out=False,
                  num_iter=4)
        got, want, _ = _run_both(kw, kw, llr, pcm=PCM3)
        if cn == "minsum":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=SOFT_ATOL)


def test_identity_updates_match_jax():
    pcm = np.array([[1, 1, 0, 1, 0, 0], [0, 1, 1, 0, 1, 0],
                    [1, 0, 1, 0, 0, 1]], np.int32)
    llr = np.random.default_rng(0).normal(size=(2, 6)).astype(np.float32)
    kw = dict(cn_update="identity", vn_update="identity", hard_out=False,
              num_iter=2)
    got, want, _ = _run_both(kw, kw, llr, pcm=pcm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_return_state_and_warm_start_match_jax():
    """return_state gives the last v2c messages (logit convention);
    msg_v2c starts the next call from them. Min-sum: bit-exact."""
    _, llr = _codeword_llrs(PCM1, 4, 2.0, 1.5, seed=3)
    kw = dict(cn_update="minsum", hard_out=False, num_iter=3,
              return_state=True)
    jd, td = jldpc.LDPCBPDecoder(PCM1, **kw), LDPCBPDecoder(PCM1, **kw)
    want, want_state = jax.jit(jd)(jnp.asarray(llr))
    got, state = td(torch.as_tensor(llr))
    assert state.shape == (4, td.num_edges)
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want2, _ = jax.jit(lambda x, s: jd(x, msg_v2c=s))(jnp.asarray(llr),
                                                     want_state)
    got2, _ = td(torch.as_tensor(llr), msg_v2c=state)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    assert not np.array_equal(got2.numpy(), got.numpy())
    # layered: the state is all zeros, as in JAX
    kw.update(cn_schedule="layered")
    _, zeros = LDPCBPDecoder(PCM1, **kw)(torch.as_tensor(llr))
    assert not zeros.any()


def test_callbacks_match_jax():
    """v2c and c2v callbacks: per-edge weights from NumPy (the trainable
    module and the functional form) within SOFT_ATOL (measured 2.1e-6:
    XLA contracts the weighted c2v and its sum into the LLRs into fused
    multiply-adds), and the EXIT and statistics callbacks'
    per-iteration records (means over [6, E]: 1e-6)."""
    _, llr = _codeword_llrs(PCM1, 6, 2.0, 1.5, seed=4)
    n_edges = int(PCM1.sum())
    rng = np.random.default_rng(5)
    w_v, w_c = (1 + 0.2 * rng.normal(size=(2, n_edges))).astype(np.float32)
    jexit, texit = jldpc.EXITCallback(4), tldpc.EXITCallback(4)
    jstat = jldpc.DecoderStatisticsCallback(4)
    tstat = tldpc.DecoderStatisticsCallback(4)
    jw = jldpc.WeightedBPCallback(n_edges)
    tw = tldpc.WeightedBPCallback(n_edges)
    with torch.no_grad():
        tw.weights.copy_(torch.as_tensor(w_v))
    base = dict(cn_update="minsum", hard_out=False, num_iter=4)
    got, want, td = _run_both(
        dict(base, v2c_callbacks=[jw.with_weights(jnp.asarray(w_v)), jexit],
             c2v_callbacks=[jw.with_weights(jnp.asarray(w_c)), jstat]),
        dict(base, v2c_callbacks=[tw, texit],
             c2v_callbacks=[tw.with_weights(torch.as_tensor(w_c)), tstat]),
        llr)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=SOFT_ATOL)
    # the trainable weights are the decoder's parameters
    assert [p is tw.weights for p in td.parameters()] == [True]
    np.testing.assert_allclose(texit.mi_avg, jexit.mi_avg, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tstat.num_calls, jstat.num_calls)
    np.testing.assert_allclose(tstat.msg_mean, jstat.msg_mean, rtol=1e-6)
    assert list(texit._counts) == [1, 1, 1, 1]


def test_internal_precision_bf16_decisions_match_jax():
    """bf16 messages on the flooding schedule (boxplus-phi, BP-8):
    identical hard decisions to JAX's bf16 path on noisy codewords, soft
    outputs within 1/16 (measured 0.03: torch's CPU index_add of bf16
    rows accumulates in f32, XLA's scatter rounds each add to bf16)."""
    for seed, sigma in ((6, 1.0), (7, 2.0)):
        _, llr = _codeword_llrs(PCM1, 50, 2.0, sigma, seed)
        kw = dict(hard_out=False, num_iter=8, internal_precision="bf16")
        got, want, _ = _run_both(kw, kw, llr)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1 / 16)


@pytest.mark.parametrize("cn", ["minsum", "offset-minsum", "boxplus",
                                "boxplus-phi"])
def test_matmul_engine_matches_jax(cn):
    """engine="matmul" (incidence products; min-sum with <=, boxplus
    clamped at the clipping value) against JAX's matmul engine, BP-5."""
    _, llr = _codeword_llrs(PCM1, 6, 2.0, 1.5, seed=8)
    kw = dict(cn_update=cn, hard_out=False, num_iter=5, engine="matmul")
    got, want, td = _run_both(kw, kw, llr)
    assert td._use_matmul_engine
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MATMUL_ATOL)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)


def test_gradients_match_jax():
    """d mean(dec(llr)^2) / d llr and / d weights of a v2c
    WeightedBPCallback, boxplus-phi BP-4 on the (3,6) code, against
    jax.grad: 1e-4 of the largest gradient (measured 4.9e-6), at LLRs
    below tanh saturation (at twice their size, 4e-4)."""
    _, llr = _codeword_llrs(PCM3, 3, 1.0, 1.5, seed=9)
    n_edges = int(PCM3.sum())
    w = (1 + 0.1 * np.random.default_rng(9).normal(size=n_edges)).astype(
        np.float32)
    jcb = jldpc.WeightedBPCallback(n_edges)

    def loss(x, weights):
        dec = jldpc.LDPCBPDecoder(PCM3, num_iter=4, hard_out=False,
                                  v2c_callbacks=[jcb.with_weights(weights)])
        return jnp.mean(dec(x) ** 2)

    want_x, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(llr),
                                                    jnp.asarray(w))
    cb = tldpc.WeightedBPCallback(n_edges)
    with torch.no_grad():
        cb.weights.copy_(torch.as_tensor(w))
    dec = LDPCBPDecoder(PCM3, num_iter=4, hard_out=False,
                        v2c_callbacks=[cb])
    x = torch.as_tensor(llr).requires_grad_()
    torch.mean(dec(x) ** 2).backward()
    for got, want in ((x.grad, want_x), (cb.weights.grad, want_w)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _jax_uses_lifted(jd):
    return jd._use_lifted


ROUTING_CASES = [
    dict(),
    dict(cn_schedule="layered"),
    dict(cn_schedule="layered", engine="pallas"),
    dict(cn_schedule="layered", engine="lifted", cn_update="minsum"),
    dict(return_state=True),
    dict(cn_update="minsum", v2c_callbacks=[lambda m, it: m]),
    dict(cn_update="identity"),
    dict(engine="segment"),
    dict(engine="matmul"),
]


def test_layered_5g_decoder_runs_the_segment_engine_as_jax():
    """The routing fault: with engine="auto", JAX's LDPC5GDecoder turns
    cn_schedule="layered" into per-base-row CN lists and takes the
    segment engine (the phi rule for the default boxplus-phi, a
    scatter-add posterior); the port used to take the lifted tanh-rule
    engine. Now every case takes the engine JAX takes, and the default
    layered decoder's output equals JAX's: hard decisions after the
    default 20 iterations on noisy codewords (they decode), soft
    marginals after 2 iterations within 3e-5 (measured 8.6e-6; the
    parent's lifted tanh-rule engine read 3.8e-6 here, so the soft check
    does not tell the two engines apart: the routing assertions pin the
    fault). (Beyond a few iterations layered boxplus is chaotic in f32: a
    1-ULP change of one input moves JAX's own marginals by 1.0 after
    20.)"""
    je, te = jldpc.LDPC5GEncoder(100, 200), LDPC5GEncoder(100, 200)
    for kw in ROUTING_CASES:
        jd, td = jldpc.LDPC5GDecoder(je, **kw), LDPC5GDecoder(te, **kw)
        assert (td.lifted is not None) == _jax_uses_lifted(jd), kw
        assert (td.num_cns, td.num_vns, td.num_edges) == \
            (jd.num_cns, jd.num_vns, jd.num_edges)
    rng = np.random.default_rng(10)
    b = rng.integers(0, 2, (6, 100)).astype(np.float32)
    c = te(torch.as_tensor(b)).numpy()
    llr = ((2 * c - 1) * 2 + rng.normal(0, 1.5, c.shape)).astype(np.float32)
    jd, td = (jldpc.LDPC5GDecoder(je, cn_schedule="layered"),
              LDPC5GDecoder(te, cn_schedule="layered"))
    assert td.lifted is None
    got = td(torch.as_tensor(llr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jd)(
        jnp.asarray(llr))))
    np.testing.assert_array_equal(got, b)
    kw = dict(cn_schedule="layered", hard_out=False, num_iter=2)
    got = LDPC5GDecoder(te, **kw)(torch.as_tensor(llr)).numpy()
    want = np.asarray(jax.jit(jldpc.LDPC5GDecoder(je, **kw))(
        jnp.asarray(llr)))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)


def test_5g_segment_path_matches_jax():
    """LDPC5GDecoder on the segment engine with return_state, the full
    codeword out (return_infobits=False, through the output
    interleaver), a warm start, prune_pcm=False and min-sum: bit-exact
    against JAX."""
    je = jldpc.LDPC5GEncoder(100, 200, num_bits_per_symbol=2)
    te = LDPC5GEncoder(100, 200, num_bits_per_symbol=2)
    rng = np.random.default_rng(11)
    b = rng.integers(0, 2, (4, 100)).astype(np.float32)
    c = te(torch.as_tensor(b)).numpy()
    llr = ((2 * c - 1) * 2 + rng.normal(0, 1.4, c.shape)).astype(np.float32)
    for prune in (True, False):
        kw = dict(cn_update="minsum", hard_out=False, num_iter=4,
                  return_infobits=False, return_state=True,
                  prune_pcm=prune)
        jd, td = jldpc.LDPC5GDecoder(je, **kw), LDPC5GDecoder(te, **kw)
        assert td.lifted is None
        want, want_state = jax.jit(jd)(jnp.asarray(llr))
        got, state = td(torch.as_tensor(llr))
        assert got.shape == (4, 200)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))
        want2, _ = jax.jit(lambda x, s: jd(x, msg_v2c=s))(
            jnp.asarray(llr), want_state)
        got2, _ = td(torch.as_tensor(llr), msg_v2c=state)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
