"""Convolutional and turbo codes of the PyTorch port against the JAX
package: the trellis tables, ``ConvEncoder`` (feed-forward and RSC,
terminated or not) and ``TurboEncoder`` bit-exact against the goldens in
``tests/codes/{conv,turbo}`` and JAX; Viterbi decisions identical to the
goldens and to JAX's; BCJR and turbo soft outputs within a stated
tolerance of JAX's, their hard decisions identical.

The JAX decoders run as one jitted program per call shape."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.fec.conv as jconv
import sionna_tpu.phy.fec.turbo as jturbo
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.fec import conv as tconv
from sionna_tpu_torch.phy.fec import turbo as tturbo
from sionna_tpu_torch.phy.utils import ebnodb2no, load_numpy_state

torch.set_num_threads(2)

CODES = Path(__file__).resolve().parent / "codes"
CONV_CASES = [
    (["101", "111"], "conv_rate_half_57_"),
    (["1101", "1111"], "conv_rate_half_6474_"),
    (["101", "111", "111"], "conv_rate_onethird_577_"),
    (["101", "111", "111", "111"], "conv_rate_onefourth_5777_"),
]
# BCJR and turbo soft outputs (logits): log-domain recursions whose f32
# exp/log rounding differs between XLA:CPU and torch (and the port
# combines two branches with logaddexp), against the largest magnitude
SOFT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(
        np.float32)


def _logits(c, amp, seed):
    """Noisy logits (positive for bit 1) of codewords ``c``."""
    rng = np.random.default_rng(seed)
    return (2 * ((2 * c - 1) * amp + rng.normal(size=c.shape))).astype(
        np.float32)


@pytest.mark.parametrize("gen_poly,rsc", [(("101", "111"), False),
                                          (("1011", "1101"), True),
                                          (("1011011", "1111001"), False),
                                          (("111", "101", "111"), True)])
def test_trellis_matches_jax(gen_poly, rsc):
    tt, jt = tconv.Trellis(gen_poly, rsc=rsc), jconv.Trellis(gen_poly, rsc=rsc)
    exported = {}
    for name in ("to_nodes", "from_nodes", "op_mat", "ip_by_tonode",
                 "op_by_tonode", "op_by_fromnode", "op_bits_by_fromnode"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
        exported[name] = getattr(jt, name)
    assert (tt.ns, tt.conv_n, tt._mu) == (jt.ns, jt.conv_n, jt._mu)
    # the trellis of an encoder, exported from JAX, checks equal
    enc = tconv.ConvEncoder(gen_poly=list(gen_poly), rsc=rsc)
    load_numpy_state(enc, {f"trellis.{k}": v for k, v in exported.items()})
    load_numpy_state(tt, exported)
    bad = jt.to_nodes.copy()
    bad[0, 0] += 1
    with pytest.raises(ValueError, match="to_nodes"):
        load_numpy_state(tt, {"to_nodes": bad})
    assert tconv.polynomial_selector(1 / 3, 5) == \
        jconv.polynomial_selector(1 / 3, 5)


@pytest.mark.parametrize("gen_poly,name", CONV_CASES)
def test_conv_encoder_golden(gen_poly, name):
    u = np.load(CODES / "conv" / f"{name}ref_u.npy")
    c_ref = np.load(CODES / "conv" / f"{name}ref_x.npy")
    enc = tconv.ConvEncoder(gen_poly=gen_poly)
    np.testing.assert_array_equal(
        enc(torch.as_tensor(u, dtype=torch.float32)).numpy(), c_ref)


@pytest.mark.parametrize("kwargs", [
    {"rate": 1 / 2, "constraint_length": 7, "terminate": True},
    {"rate": 1 / 3, "constraint_length": 4, "rsc": True, "terminate": True},
    {"gen_poly": ["1011", "1101"], "rsc": True},
])
def test_conv_encoder_matches_jax(kwargs):
    b = _bits((2, 3, 50), seed=1)
    te, je = tconv.ConvEncoder(**kwargs), jconv.ConvEncoder(**kwargs)
    got = te(torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(je(jnp.asarray(b))))
    assert (te.k, te.n, te.coderate) == (je.k, je.n, je.coderate)


@pytest.mark.parametrize("gen_poly,name", CONV_CASES)
def test_viterbi_decoder_golden(gen_poly, name):
    y = np.load(CODES / "conv" / f"{name}ref_y.npy")
    uhat_ref = np.load(CODES / "conv" / f"{name}ref_uhat.npy")
    no = float(ebnodb2no(4.95, num_bits_per_symbol=2, coderate=1.))
    dec = tconv.ViterbiDecoder(gen_poly=gen_poly, method="soft_llr")
    np.testing.assert_array_equal(
        dec(torch.as_tensor(2 * y / no, dtype=torch.float32)).numpy(),
        uhat_ref)


@pytest.mark.parametrize("method", ["soft_llr", "hard"])
def test_viterbi_matches_jax(method):
    """Decisions identical to JAX's on noisy blocks (hard: on the noisy
    channel bits, where branch-metric ties are routine), terminated and
    not, with and without the termination bits in the output."""
    for kwargs in ({"rate": 1 / 2, "constraint_length": 5, "terminate": True},
                   {"rate": 1 / 3, "constraint_length": 3}):
        te = tconv.ConvEncoder(**kwargs)
        c = te(torch.as_tensor(_bits((16, 60), seed=2))).numpy()
        y = _logits(c, 0.7, seed=3)
        if method == "hard":
            y = (y > 0).astype(np.float32)
        for info in (True, False):
            td = tconv.ViterbiDecoder(encoder=te, method=method,
                                      return_info_bits=info)
            jd = jconv.ViterbiDecoder(gen_poly=te.gen_poly,
                                      terminate=te.terminate, method=method,
                                      return_info_bits=info)
            got = td(torch.as_tensor(y)).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jax.jit(jd)(jnp.asarray(y))))
            assert got.shape[-1] == (60 if info else c.shape[-1]
                                     // len(te.gen_poly))


@pytest.mark.parametrize("algorithm", ["map", "log", "maxlog"])
def test_bcjr_matches_jax(algorithm):
    """Soft outputs within SOFT_RTOL of JAX's (the max error is
    printed) and identical hard decisions; with a prior, terminated and
    not, feed-forward and RSC."""
    for kwargs in ({"rate": 1 / 2, "constraint_length": 4, "terminate": True},
                   {"gen_poly": ["1011", "1101"], "rsc": True}):
        te = tconv.ConvEncoder(**kwargs)
        c = te(torch.as_tensor(_bits((8, 64), seed=4))).numpy()
        y = _logits(c, 0.6, seed=5)
        prior = np.random.default_rng(6).normal(size=(8, 64)).astype(
            np.float32)
        dkw = {"gen_poly": te.gen_poly, "rsc": te.trellis.rsc,
               "terminate": te.terminate, "algorithm": algorithm}
        td = tconv.BCJRDecoder(hard_out=False, **dkw)
        jd = jconv.BCJRDecoder(hard_out=False, **dkw)
        jrun = jax.jit(lambda v, p, jd=jd: jd(v, prior=p))
        for p in (None, prior):
            got = td(torch.as_tensor(y), prior=None if p is None
                     else torch.as_tensor(p)).numpy()
            want = np.asarray(jrun(jnp.asarray(y), jnp.zeros_like(prior)
                                   if p is None else jnp.asarray(p)))
            err = np.abs(got - want).max()
            print(f"BCJR {algorithm} {kwargs}: max |port - JAX| {err:.3e} "
                  f"(max |llr| {np.abs(want).max():.1f})")
            assert err <= SOFT_RTOL * np.abs(want).max()
            hard = tconv.BCJRDecoder(**dkw)(
                torch.as_tensor(y), prior=None if p is None
                else torch.as_tensor(p)).numpy()
            np.testing.assert_array_equal(hard, (want > 0).astype(np.float32))


@pytest.mark.parametrize("k", [40, 112, 168, 432])
def test_turbo_encoder_golden(k):
    u = np.load(CODES / "turbo" / f"ref_k{k}_u.npy")
    c_ref = np.load(CODES / "turbo" / f"ref_k{k}_x.npy")
    enc = tturbo.TurboEncoder(rate=1 / 3, terminate=True, constraint_length=4)
    np.testing.assert_array_equal(
        enc(torch.as_tensor(u, dtype=torch.float32)).numpy(), c_ref)


@pytest.mark.parametrize("kwargs", [
    {"rate": 1 / 2, "constraint_length": 3},
    {"rate": 1 / 2, "constraint_length": 4, "terminate": True},
    {"rate": 1 / 3, "constraint_length": 5, "terminate": True},
])
def test_turbo_encoder_matches_jax(kwargs):
    """Codewords bit-exact; the internal interleaver's permutation and
    the constituent trellis, exported from JAX, load into the port's."""
    b = _bits((2, 2, 100), seed=7)
    te, je = tturbo.TurboEncoder(**kwargs), jturbo.TurboEncoder(**kwargs)
    got = te(torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(je(jnp.asarray(b))))
    assert (te.k, te.n, te.coderate, te.constraint_length) == \
        (je.k, je.n, je.coderate, je.constraint_length)
    np.testing.assert_array_equal(te.punct_pattern, je.punct_pattern)
    perm = je.internal_interleaver._perms(100)[0]
    exported = {"internal_interleaver.perm": perm}
    exported.update({f"convencoder.trellis.{k}": getattr(
        je.convencoder.trellis, k) for k in ("to_nodes", "from_nodes")})
    load_numpy_state(te, exported)
    with pytest.raises(ValueError, match="perm"):
        load_numpy_state(te, {"internal_interleaver.perm": perm[::-1]})


@pytest.mark.parametrize("k", [40, 112, 168])
def test_turbo_decoder_golden(k):
    uhat_ref = np.load(CODES / "turbo" / f"ref_k{k}_uhat.npy")
    y = np.load(CODES / "turbo" / f"ref_k{k}_y.npy")
    enc = tturbo.TurboEncoder(rate=1 / 3, terminate=True, constraint_length=4)
    dec = tturbo.TurboDecoder(enc, num_iter=10)
    no = 1 / ((1 / 3) * 10 ** (0.0 / 10))
    np.testing.assert_array_equal(
        dec(torch.as_tensor(-4. * y / no, dtype=torch.float32)).numpy(),
        uhat_ref)


@pytest.mark.parametrize("kwargs", [
    {"rate": 1 / 3, "constraint_length": 4, "terminate": True},
    {"rate": 1 / 2, "constraint_length": 3},
])
def test_turbo_decoder_matches_jax(kwargs):
    """Soft outputs within SOFT_RTOL of JAX's after 6 iterations (the max
    error is printed), identical hard decisions; the decoder built from
    its arguments is the one built from the encoder."""
    te, je = tturbo.TurboEncoder(**kwargs), jturbo.TurboEncoder(**kwargs)
    c = te(torch.as_tensor(_bits((8, 120), seed=8))).numpy()
    y = _logits(c, 0.5, seed=9)
    td = tturbo.TurboDecoder(te, num_iter=6, hard_out=False)
    jd = jturbo.TurboDecoder(je, num_iter=6, hard_out=False)
    got = td(torch.as_tensor(y)).numpy()
    want = np.asarray(jax.jit(jd)(jnp.asarray(y)))
    err = np.abs(got - want).max()
    print(f"turbo {kwargs}: max |port - JAX| {err:.3e} (max |llr| "
          f"{np.abs(want).max():.1f})")
    assert err <= SOFT_RTOL * np.abs(want).max()
    assert (td.k, td.n, td.num_iter) == (120, y.shape[-1], 6)
    hard = tturbo.TurboDecoder(num_iter=6, **kwargs)(torch.as_tensor(y))
    np.testing.assert_array_equal(hard.numpy(), (want > 0).astype(np.float32))


def test_turbo_utils_match_jax():
    for cl in (3, 4, 5, 6):
        assert tturbo.polynomial_selector(cl) == jturbo.polynomial_selector(cl)
    for rate in (1 / 2, 1 / 3):
        np.testing.assert_array_equal(tturbo.puncture_pattern(rate, 1 / 2),
                                      jturbo.puncture_pattern(rate, 1 / 2))
    tt, jt = tturbo.TurboTermination(4), jturbo.TurboTermination(4)
    assert tt.get_num_term_syms() == jt.get_num_term_syms() == 4
    t1, t2 = _bits((2, 6), seed=10), _bits((2, 6), seed=11)
    merged = tt.termbits_conv2turbo(torch.as_tensor(t1), torch.as_tensor(t2))
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jt.termbits_conv2turbo(jnp.asarray(t1),
                                                          jnp.asarray(t2))))
    for got, want in zip(tt.term_bits_turbo2conv(merged), (t1, t2)):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tturbo.TurboEncoder(rate=2 / 3)
    with pytest.raises(TypeError):
        tturbo.TurboDecoder(encoder=object())
