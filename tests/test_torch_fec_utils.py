"""FEC utilities and the linear codes of the PyTorch port against the JAX
package: the GF(2) helpers and alist loading bit-exact, LinearEncoder
bit-exact, OSDecoder decisions equal, the J-function, llr2mi and the
analytic EXIT curves to f32 (or f64) rounding, and GaussianPriorSource by
its moments."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.fec.utils as jutils
from sionna_tpu.phy.fec.linear import LinearEncoder as JLinearEncoder
from sionna_tpu.phy.fec.linear import OSDecoder as JOSDecoder
import sionna_tpu_torch.phy.fec.utils as tutils
from sionna_tpu_torch.phy.fec.linear import LinearEncoder, OSDecoder
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

CODES = Path(__file__).resolve().parent / "codes" / "ldpc"


def _gm_file(name):
    """A generic code's generator matrix from its (row, col) 1-based
    index file ``tests/codes/ldpc/k{k}_n{n}_G.npy``."""
    k, n = (int(p[1:]) for p in name.split("_")[:2])
    ids = np.load(CODES / name).astype(np.int64)
    gm = np.zeros((k, n), np.int64)
    gm[ids[0] - 1, ids[1] - 1] = 1
    return gm


@pytest.mark.parametrize("pcm_id", [0, 1, 2, 3, 4])
def test_gf2_helpers_match_jax(pcm_id):
    """Example codes, make_systematic, pcm2gm, gm2pcm, verify_gm_pcm:
    bit-exact (the same NumPy elimination)."""
    pcm, k, n, r = tutils.load_parity_check_examples(pcm_id)
    jpcm, jk, jn, jr = jutils.load_parity_check_examples(pcm_id)
    np.testing.assert_array_equal(pcm, jpcm)
    assert (k, n, r) == (jk, jn, jr)
    for is_pcm in (False, True):
        got, want = (f(pcm, is_pcm=is_pcm) for f in
                     (tutils.make_systematic, jutils.make_systematic))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    gm = tutils.pcm2gm(pcm)
    np.testing.assert_array_equal(gm, jutils.pcm2gm(pcm))
    assert tutils.verify_gm_pcm(gm, pcm)
    np.testing.assert_array_equal(tutils.gm2pcm(gm), jutils.gm2pcm(gm))
    bad = gm.copy()
    bad[0, 0] = 1 - bad[0, 0]
    assert tutils.verify_gm_pcm(bad, pcm) == jutils.verify_gm_pcm(bad, pcm)


def test_alist_and_int_helpers_match_jax():
    path = CODES / "wimax_576_0.5.alist"
    alist = tutils.load_alist(path)
    assert alist == jutils.load_alist(path)
    got = tutils.alist2mat(alist, verbose=False)
    want = jutils.alist2mat(alist, verbose=False)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (288, 576, 0.5)
    for num, length in ((0, 1), (5, 4), (1023, 10), (6, 0)):
        bits = tutils.int2bin(num, length)
        assert bits == jutils.int2bin(num, length)
        assert tutils.bin2int(bits) == jutils.bin2int(bits)
    ints = np.array([[5, 2, 0], [7, 15, 9]], np.int32)
    bits = tutils.int2bin_torch(torch.as_tensor(ints), 4)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jutils.int2bin_jnp(jnp.asarray(ints), 4)))
    np.testing.assert_array_equal(tutils.bin2int_torch(bits).numpy(), ints)
    assert tutils.bin2int_tf is tutils.bin2int_torch
    assert tutils.int2bin_tf is tutils.int2bin_torch
    x = np.array([-3.0, -2.0, 0.4, 1.0, 2.6, 5.0], np.float32)
    np.testing.assert_array_equal(tutils.int_mod_2(torch.as_tensor(x)),
                                  np.asarray(jutils.int_mod_2(x)))


def test_generate_reg_ldpc_is_regular():
    from sionna_tpu_torch.phy import config
    seed = config.seed
    config.seed = 4
    try:
        pcm, k, n, r = tutils.generate_reg_ldpc(3, 6, 100, verbose=False)
    finally:
        config.seed = seed
    assert pcm.shape == (n - k, n) == (50, 100) and r == 0.5
    # each edge socket is used once; collisions cancel in pairs (XOR)
    assert np.all(pcm.sum(axis=0) <= 3) and np.all(pcm.sum(axis=1) <= 6)
    assert np.all((pcm.sum(axis=0) - 3) % 2 == 0)


@pytest.mark.parametrize("name", ["k64_n128_G.npy", "k75_n210_G.npy"])
def test_linear_encoder_bit_exact(name):
    gm = _gm_file(name)
    k = gm.shape[0]
    b = np.random.default_rng(k).integers(0, 2, (5, 3, k)).astype(
        np.float32)
    enc = LinearEncoder(gm)
    got = enc(torch.as_tensor(b))
    assert got.shape == (5, 3, gm.shape[1]) and got.dtype == torch.float32
    want = np.asarray(JLinearEncoder(gm)(jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(enc.gm, gm.astype(np.float32))
    # from the parity-check matrix: the same pcm2gm, the same codewords
    pcm = tutils.gm2pcm(gm)
    np.testing.assert_array_equal(
        LinearEncoder(pcm, is_pcm=True)(torch.as_tensor(b)).numpy(),
        np.asarray(JLinearEncoder(pcm, is_pcm=True)(jnp.asarray(b))))
    with pytest.raises(ValueError):
        LinearEncoder(gm * 2)


@pytest.mark.parametrize("pcm_id,t,sigma", [(0, 2, 0.9), (1, 1, 0.7)])
def test_osd_decisions_match_jax(pcm_id, t, sigma):
    """OSD of order t on noisy codewords (and, for the Hamming code, on
    exact +-5 LLRs, where every reliability ties and the stable sort
    decides): identical decisions, and the port's equal the sent
    codeword where JAX's do."""
    pcm, k, n, _ = tutils.load_parity_check_examples(pcm_id)
    gm = tutils.pcm2gm(pcm)
    rng = np.random.default_rng(pcm_id)
    b = rng.integers(0, 2, (12, k)).astype(np.float32)
    c = (b @ gm % 2).astype(np.float32)
    llr = ((2 * c - 1) * 2.0 + rng.normal(0, sigma * 2, c.shape)).astype(
        np.float32)
    llr[0] = (2 * c[0] - 1) * 5.0
    got = OSDecoder(pcm, t=t, is_pcm=True)(torch.as_tensor(llr)).numpy()
    want = np.asarray(jax.jit(JOSDecoder(pcm, t=t, is_pcm=True))(
        jnp.asarray(llr)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], c[0])
    # the generator matrix taken from an encoder gives the same decoder
    enc = LinearEncoder(gm)
    np.testing.assert_array_equal(
        OSDecoder(encoder=enc, t=t)(torch.as_tensor(llr)).numpy(), got)


def test_j_function_llr2mi_exit_match_jax():
    """f32 inputs to f32 rounding (pow/log2 of XLA:CPU and torch differ
    in the last place: 4 ULP; llr2mi's means of 50 terms of |x| <= 1 are
    summed in another order, so 1e-7 absolute); the analytic EXIT curves
    run in f64 in both (NumPy inputs) and agree to 1e-12."""
    mu = np.array([0.01, 0.5, 1.0, 4.0, 10.0, 30.0], np.float32)
    np.testing.assert_allclose(tutils.j_fun(torch.as_tensor(mu)).numpy(),
                               np.asarray(jutils.j_fun(jnp.asarray(mu))),
                               rtol=5e-7, atol=0)
    mi = np.array([1e-3, 0.1, 0.5, 0.9, 0.999], np.float32)
    np.testing.assert_allclose(
        tutils.j_fun_inv(torch.as_tensor(mi)).numpy(),
        np.asarray(jutils.j_fun_inv(jnp.asarray(mi))), rtol=5e-7, atol=0)
    llr = np.random.default_rng(0).normal(2, 3, (4, 50)).astype(np.float32)
    for reduce_dims in (True, False):
        np.testing.assert_allclose(
            tutils.llr2mi(torch.as_tensor(llr),
                          reduce_dims=reduce_dims).numpy(),
            np.asarray(jutils.llr2mi(jnp.asarray(llr),
                                     reduce_dims=reduce_dims)),
            rtol=5e-7, atol=1e-7)
    pcm = tutils.load_parity_check_examples(3)[0]
    for got, want in zip(tutils.get_exit_analytic(pcm, 3.0),
                         jutils.get_exit_analytic(pcm, 3.0)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(no=0.5), dict(mi=0.3)])
def test_gaussian_prior_source_moments(kw):
    """Mean -mu and variance 2 mu, mu = 2 / no (or j_fun_inv(mi)), the
    same as JAX's source: 400 000 samples, 5 standard errors."""
    n = 400_000
    gen = torch.Generator().manual_seed(1)
    llr = tutils.GaussianPriorSource()([n], generator=gen, **kw)
    assert llr.shape == (n,) and llr.dtype == torch.float32
    jllr = np.asarray(jutils.GaussianPriorSource()(
        [n], key=jax.random.PRNGKey(1), **kw), np.float64)
    mu = 2 / kw["no"] if "no" in kw else float(
        tutils.j_fun_inv(torch.tensor(kw["mi"])))
    x = llr.double().numpy()
    for sample in (x, jllr):
        assert abs(sample.mean() + mu) < 5 * np.sqrt(2 * mu / n)
        assert abs(sample.var() / (2 * mu) - 1) < 5 * np.sqrt(2 / n)
    with pytest.raises(ValueError):
        tutils.GaussianPriorSource()([4])
