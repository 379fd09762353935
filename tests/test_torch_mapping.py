"""Mapping and AWGN of the PyTorch port against the JAX package: points
and mapper bit-exact, demapper LLRs to f32 rounding, trainable points
loaded with ``load_numpy_state``, and the random blocks by statistics
(``jax.random`` streams cannot be matched)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.mapping as jp
import sionna_tpu_torch.phy as tp
from sionna_tpu_torch.phy.utils import load_numpy_state
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

# Demapper LLRs on the separable path (Gray QAM, the default): the same
# formula as JAX's, the points folded in the same order; maxlog is then
# bit-exact, and app differs only in the rounding of logaddexp (XLA:CPU's
# exp/log1p against libm's): measured below 8e-6 at |LLR| <= ~270, 16- to
# 256-QAM, with and without a prior.
SEP_RTOL, SEP_ATOL = 1e-6, 1e-5
# The table path (a ``points`` override, custom points): torch.logsumexp
# against jax.scipy's over the masked 2^K logits, both f32: a few ULP of
# the largest exponent (|LLR| up to ~30 here).
LLR_RTOL, LLR_ATOL = 1e-4, 1e-4


@pytest.mark.parametrize("kind,nbps", [("qam", 2), ("qam", 4), ("qam", 6),
                                       ("qam", 8), ("pam", 1), ("pam", 3)])
def test_points_match_jax(kind, nbps):
    fj, ft = getattr(jp, kind), getattr(tp, kind)
    for normalize in (True, False):
        np.testing.assert_array_equal(ft(nbps, normalize=normalize),
                                      fj(nbps, normalize=normalize))
    cj = jp.Constellation(kind, nbps)
    ct = tp.Constellation(kind, nbps)
    np.testing.assert_array_equal(ct.points.numpy(), np.asarray(cj.points))
    np.testing.assert_array_equal(ct.points_host, cj.points_host)
    assert ct.points.dtype == torch.complex64


@pytest.mark.parametrize("kind,nbps", [("qam", 2), ("qam", 4), ("qam", 6),
                                       ("qam", 8), ("pam", 2)])
def test_mapper_bit_exact(kind, nbps):
    rng = np.random.default_rng(nbps)
    bits = rng.integers(0, 2, (3, 5, nbps * 40)).astype(np.float32)
    mj, mt = jp.Mapper(kind, nbps), tp.Mapper(kind, nbps)
    # the default path: separable (where-tree) for Gray QAM, the table
    # for PAM, in both packages
    got = mt(torch.as_tensor(bits))
    want = np.asarray(mj(jnp.asarray(bits)))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a points override selects the table path in both packages
    got = mt(torch.as_tensor(bits), points=mt.constellation.raw_points)
    want = np.asarray(mj(jnp.asarray(bits), points=mj.constellation._points))
    np.testing.assert_array_equal(got.numpy(), want)
    x, ind = tp.Mapper(kind, nbps, return_indices=True)(torch.as_tensor(bits))
    xj, indj = jp.Mapper(kind, nbps, return_indices=True)(jnp.asarray(bits))
    np.testing.assert_array_equal(ind.numpy(), np.asarray(indj))
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))


def _noisy_symbols(rng, nbps, no, shape=(4, 300)):
    pts = jp.qam(nbps).astype(np.complex64)
    x = pts[rng.integers(0, 2 ** nbps, shape)]
    n = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * \
        np.sqrt(no / 2)
    return (x + n).astype(np.complex64)


@pytest.mark.parametrize("method", ["app", "maxlog"])
@pytest.mark.parametrize("nbps", [2, 4, 6, 8])
def test_demapper_matches_jax(method, nbps):
    """The default (separable) path at three noise levels, with and
    without a prior (per row ``no`` there), and hard decisions."""
    rng = np.random.default_rng(10 + nbps)
    dj, dt = jp.Demapper(method, "qam", nbps), tp.Demapper(method, "qam",
                                                           nbps)
    for no in (np.float32(0.01), np.float32(0.2), np.float32(1.0)):
        y = _noisy_symbols(rng, nbps, no)
        want = np.asarray(dj(jnp.asarray(y), no))
        got = dt(torch.as_tensor(y), torch.tensor(no))
        assert got.dtype == torch.float32 and got.shape == want.shape
        if method == "maxlog":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=SEP_RTOL,
                                       atol=SEP_ATOL)
        prior = rng.normal(size=(nbps,)).astype(np.float32)
        no_rows = np.full((4, 1), no, np.float32)
        want = np.asarray(dj(jnp.asarray(y), jnp.asarray(no_rows),
                             prior=jnp.asarray(prior)))
        got = dt(torch.as_tensor(y), torch.as_tensor(no_rows),
                 prior=torch.as_tensor(prior))
        np.testing.assert_allclose(got.numpy(), want, rtol=SEP_RTOL,
                                   atol=SEP_ATOL)
    hard = tp.Demapper(method, "qam", nbps, hard_out=True)(
        torch.as_tensor(y), torch.tensor(no))
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(jp.Demapper(method, "qam", nbps,
                                             hard_out=True)(
            jnp.asarray(y), no)))


@pytest.mark.parametrize("method", ["app", "maxlog"])
def test_demapper_table_path_matches_jax(method):
    """A points override takes the table path in both packages."""
    rng = np.random.default_rng(5)
    no = np.float32(0.2)
    y = _noisy_symbols(rng, 4, no)
    dj, dt = jp.Demapper(method, "qam", 4), tp.Demapper(method, "qam", 4)
    want = np.asarray(dj(jnp.asarray(y), no,
                         points=dj.constellation._points))
    got = dt(torch.as_tensor(y), torch.tensor(no),
             points=dt.constellation.raw_points)
    np.testing.assert_allclose(got.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
    prior = rng.normal(size=(4, 300, 4)).astype(np.float32)
    want = np.asarray(dj(jnp.asarray(y), no, prior=jnp.asarray(prior),
                         points=dj.constellation._points))
    got = dt(torch.as_tensor(y), torch.tensor(no),
             prior=torch.as_tensor(prior),
             points=dt.constellation.raw_points)
    np.testing.assert_allclose(got.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)


def test_trainable_points_loaded_from_jax():
    rng = np.random.default_rng(3)
    raw = (rng.normal(size=16) + 1j * rng.normal(size=16)).astype(
        np.complex64)
    cj = jp.Constellation("custom", 4, points=raw, center=True)
    ct = tp.Constellation("custom", 4, points=np.zeros(16), center=True)
    load_numpy_state(ct, {"raw_points": np.asarray(cj._points)})
    np.testing.assert_allclose(ct.points.numpy(), np.asarray(cj.points),
                               rtol=1e-6, atol=1e-6)  # f32 mean/sqrt order
    no = np.float32(0.3)
    y = _noisy_symbols(rng, 4, no)
    want = np.asarray(jp.Demapper("app", constellation=cj)(
        jnp.asarray(y), no))
    dem = tp.Demapper("app", constellation=ct)
    got = dem(torch.as_tensor(y), torch.tensor(no))
    np.testing.assert_allclose(got.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
    bits = rng.integers(0, 2, (2, 64)).astype(np.float32)
    x = tp.Mapper(constellation=ct)(torch.as_tensor(bits))
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jp.Mapper(constellation=cj)(jnp.asarray(bits))),
        rtol=1e-6, atol=1e-6)
    # a call-time points override is the same as loading the points
    qam16 = tp.Mapper("qam", 4)
    qam16.constellation.center = True
    assert torch.equal(qam16(torch.as_tensor(bits), points=ct.raw_points), x)
    np.testing.assert_array_equal(
        tp.Demapper("app", "qam", 4, constellation=ct)(
            torch.as_tensor(y), torch.tensor(no)).numpy(),
        tp.Demapper("app", constellation=qam16.constellation)(
            torch.as_tensor(y), torch.tensor(no),
            points=ct.raw_points).numpy())
    # the points train: gradients reach the raw parameter
    ct.raw_points.requires_grad_(True)
    dem(torch.as_tensor(y), torch.tensor(no)).square().mean().backward()
    assert ct.raw_points.grad is not None
    assert bool(torch.isfinite(ct.raw_points.grad).all())
    # nested names, and the errors
    m = tp.Mapper(constellation=tp.Constellation("qam", 4))
    load_numpy_state(m, {"constellation.raw_points": raw})
    assert torch.equal(m.constellation.raw_points.detach(),
                       torch.as_tensor(raw))
    with pytest.raises(ValueError):
        load_numpy_state(ct, {"raw_points": raw[:8]})
    with pytest.raises(KeyError):
        load_numpy_state(ct, {"points": raw})


def test_binary_source_statistics():
    src = tp.BinarySource()
    b = src([400, 500])
    assert b.shape == (400, 500) and b.dtype == torch.float32
    assert set(torch.unique(b).tolist()) <= {0.0, 1.0}
    # mean of 2e5 fair bits: std 1.1e-3, bound at 4.5 std
    assert abs(float(b.mean()) - 0.5) < 5e-3
    # neighbouring bits independent: P(b_i = b_{i+1}) = 1/2
    assert abs(float((b[:, 1:] == b[:, :-1]).float().mean()) - 0.5) < 5e-3
    s1 = tp.BinarySource(seed=7)
    s2 = tp.BinarySource(seed=7)
    assert torch.equal(s1([1000]), s2([1000]))
    assert tp.BinarySource(precision="double")([3]).dtype == torch.float64


def test_awgn_statistics():
    awgn = tp.AWGN()
    x = torch.zeros(200_000, dtype=torch.complex64)
    y = awgn(x, 0.5)
    assert y.dtype == torch.complex64 and y.shape == x.shape
    re, im = y.real.double(), y.imag.double()
    # variance 0.25 per axis from 2e5 samples: std 7.9e-4
    for part in (re, im):
        assert abs(float(part.mean())) < 5e-3
        assert abs(float(part.var()) - 0.25) < 5e-3
    # real and imaginary parts independent
    assert abs(float(torch.corrcoef(torch.stack([re, im]))[0, 1])) < 1e-2
    # per-row no broadcasts over the last axis; the signal passes through
    no = torch.tensor([1e-6, 1.0])
    y = awgn(torch.ones(2, 100_000, dtype=torch.complex64), no)
    assert float((y[0] - 1).abs().max()) < 1e-2
    assert abs(float((y[1] - 1).real.var()) - 0.5) < 2e-2
    g = torch.Generator().manual_seed(1)
    y1 = awgn(x[:10], 0.5, generator=g)
    g.manual_seed(1)
    assert torch.equal(awgn(x[:10], 0.5, generator=g), y1)


# Symbol-level blocks: softmax/log-softmax over at most 16 logits and
# sums of up to 4 log-sigmoids in f32 (XLA:CPU's exp/log against libm's).
SYM_RTOL, SYM_ATOL = 1e-5, 1e-5


def test_symbol_demapper_matches_jax():
    rng = np.random.default_rng(21)
    no = np.float32(0.3)
    y = _noisy_symbols(rng, 4, no, (3, 50))
    prior = rng.normal(size=(3, 50, 16)).astype(np.float32)
    for kw in ({}, {"prior": prior}):
        want = np.asarray(jp.SymbolDemapper("qam", 4)(
            jnp.asarray(y), no, **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = tp.SymbolDemapper("qam", 4)(
            torch.as_tensor(y), torch.tensor(no),
            **{k: torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, rtol=SYM_RTOL,
                                   atol=SYM_ATOL)
    hard = tp.SymbolDemapper("qam", 4, hard_out=True)(torch.as_tensor(y),
                                                      torch.tensor(no))
    assert hard.dtype == torch.int32
    np.testing.assert_array_equal(hard.numpy(), np.asarray(
        jp.SymbolDemapper("qam", 4, hard_out=True)(jnp.asarray(y), no)))


def test_llrs2symbol_logits_matches_jax():
    rng = np.random.default_rng(22)
    llr = (4 * rng.normal(size=(3, 20, 4))).astype(np.float32)
    want = np.asarray(jp.LLRs2SymbolLogits(4)(jnp.asarray(llr)))
    got = tp.LLRs2SymbolLogits(4)(torch.as_tensor(llr))
    assert got.shape == want.shape == (3, 20, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=SYM_RTOL,
                               atol=SYM_ATOL)
    np.testing.assert_array_equal(
        tp.LLRs2SymbolLogits(4, hard_out=True)(torch.as_tensor(llr)).numpy(),
        np.asarray(jp.LLRs2SymbolLogits(4, hard_out=True)(jnp.asarray(llr))))


def test_symbol_logits2moments_matches_jax():
    rng = np.random.default_rng(23)
    logits = (3 * rng.normal(size=(5, 7, 16))).astype(np.float32)
    mj, vj = jp.SymbolLogits2Moments("qam", 4)(jnp.asarray(logits))
    mt, vt = tp.SymbolLogits2Moments("qam", 4)(torch.as_tensor(logits))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=SYM_RTOL,
                               atol=SYM_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=SYM_RTOL,
                               atol=SYM_ATOL)


def test_symbol_inds2bits_and_pam_qam_index_maps_match_jax():
    rng = np.random.default_rng(24)
    ind = rng.integers(0, 64, (4, 9))
    np.testing.assert_array_equal(
        tp.SymbolInds2Bits(6)(torch.as_tensor(ind)).numpy(),
        np.asarray(jp.SymbolInds2Bits(6)(ind)))
    for nbps in (2, 4, 6):
        ind = rng.integers(0, 2 ** nbps, (3, 11))
        p1t, p2t = tp.QAM2PAM(nbps)(torch.as_tensor(ind))
        p1j, p2j = jp.QAM2PAM(nbps)(ind)
        np.testing.assert_array_equal(p1t.numpy(), np.asarray(p1j))
        np.testing.assert_array_equal(p2t.numpy(), np.asarray(p2j))
        # PAM2QAM inverts QAM2PAM
        back = tp.PAM2QAM(nbps)(p1t, p2t)
        np.testing.assert_array_equal(back.numpy(), ind)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jp.PAM2QAM(nbps)(p1j, p2j)))
        # soft: PAM logits combined into QAM logits
        h = 2 ** (nbps // 2)
        l1 = rng.normal(size=(3, h)).astype(np.float32)
        l2 = rng.normal(size=(3, h)).astype(np.float32)
        np.testing.assert_array_equal(
            tp.PAM2QAM(nbps, hard_in_out=False)(torch.as_tensor(l1),
                                                torch.as_tensor(l2)).numpy(),
            np.asarray(jp.PAM2QAM(nbps, hard_in_out=False)(l1, l2)))


@pytest.mark.parametrize("kind,nbps", [("qam", 4), ("pam", 2)])
def test_symbol_sources(kind, nbps):
    """Random blocks by statistics; the mapping of their indices to bits
    and symbols exactly as JAX maps them."""
    cls = tp.QAMSource if kind == "qam" else tp.PAMSource
    src = cls(nbps, return_indices=True, return_bits=True, seed=3)
    x, ind, b = src([50, 400])
    assert x.shape == ind.shape == (50, 400) and b.shape == (50, 400 * nbps)
    assert x.dtype == torch.complex64 and ind.dtype == torch.int32
    # the symbols and indices of the bits, as the JAX package maps them
    xj, indj = jp.Mapper(kind, nbps, return_indices=True)(
        jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(ind.numpy(), np.asarray(indj))
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(
        b.numpy().reshape(50, 400, nbps),
        np.asarray(jp.SymbolInds2Bits(nbps)(np.asarray(indj))))
    # uniform over the 2^K points: 2e4 draws, each count within 5 std
    counts = np.bincount(ind.numpy().reshape(-1), minlength=2 ** nbps)
    n, p = ind.numel(), 1 / 2 ** nbps
    assert np.all(np.abs(counts - n * p) < 5 * np.sqrt(n * p * (1 - p)))
    # unit average energy
    assert abs(float((x.abs() ** 2).mean()) - 1) < 0.03
    # a seed reproduces the draw; another seed does not
    assert torch.equal(cls(nbps, seed=3)([50, 400]), x)
    assert not torch.equal(cls(nbps, seed=4)([50, 400]), x)
    assert tp.SymbolSource(kind, nbps)([2, 3]).shape == (2, 3)


# Separable against table path in the port: the table path's exponents
# carry the off-axis distance that the separable path drops, so the two
# round apart by a few ULP of the largest exponent of the symbol,
# max_p |y - p|^2 / no (measured <= 4 ULP, 4- to 256-QAM). chip_smoke.py
# phase 13 holds the card to the same bound at the flagship's shape.
SEP_TABLE_ULPS = 8


@pytest.mark.parametrize("nbps", [2, 4, 6, 8])
def test_separable_and_table_paths_agree(nbps):
    rng = np.random.default_rng(30 + nbps)
    pts = jp.qam(nbps).astype(np.complex64)
    for method in ("app", "maxlog"):
        dem = tp.Demapper(method, "qam", nbps)
        for no in (0.01, 0.2, 1.0):
            y = _noisy_symbols(rng, nbps, no, (8, 500))
            no_sym = (no * (0.5 + rng.random(y.shape))).astype(np.float32)
            sep = dem(torch.as_tensor(y), torch.as_tensor(no_sym)).numpy()
            table = dem(torch.as_tensor(y), torch.as_tensor(no_sym),
                        points=dem.constellation.raw_points).numpy()
            largest = (np.abs(y[..., None] - pts) ** 2
                       / no_sym[..., None]).max(-1)
            bound = SEP_TABLE_ULPS * np.finfo(np.float32).eps \
                * np.repeat(largest, nbps, axis=-1)
            assert np.all(np.abs(sep - table) <= bound)
