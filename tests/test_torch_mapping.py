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

# Demapper LLRs: the port reduces the 2^K points with torch.logsumexp
# (or max) over masked logits; JAX's Gray-QAM fast path reduces per axis
# with pairwise logaddexp. Both are f32; the rounding differs by a few
# ULP of the largest exponent (|LLR| up to ~30 here).
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
    assert ct.points.dtype == torch.complex64


@pytest.mark.parametrize("kind,nbps", [("qam", 2), ("qam", 4), ("qam", 6),
                                       ("pam", 2)])
def test_mapper_bit_exact(kind, nbps):
    rng = np.random.default_rng(nbps)
    bits = rng.integers(0, 2, (3, 5, nbps * 40)).astype(np.float32)
    mj = jp.Mapper(kind, nbps)
    got = tp.Mapper(kind, nbps)(torch.as_tensor(bits))
    # the port has JAX's table path (a points override selects it there)
    want = np.asarray(mj(jnp.asarray(bits),
                         points=mj.constellation._points))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if nbps <= 4:
        # JAX's default separable path normalizes the points in NumPy;
        # up to 16-QAM that is bit-identical to the table path too
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(mj(jnp.asarray(bits))))
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
@pytest.mark.parametrize("nbps", [2, 4, 6])
def test_demapper_matches_jax(method, nbps):
    rng = np.random.default_rng(10 + nbps)
    no = np.float32(0.2)
    y = _noisy_symbols(rng, nbps, no)
    want = np.asarray(jp.Demapper(method, "qam", nbps)(jnp.asarray(y), no))
    got = tp.Demapper(method, "qam", nbps)(torch.as_tensor(y),
                                           torch.tensor(no))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
    # with a prior, and with no given per row
    prior = rng.normal(size=(nbps,)).astype(np.float32)
    no_rows = np.full((4, 1), no, np.float32)
    want = np.asarray(jp.Demapper(method, "qam", nbps)(
        jnp.asarray(y), jnp.asarray(no_rows), prior=jnp.asarray(prior)))
    got = tp.Demapper(method, "qam", nbps)(
        torch.as_tensor(y), torch.as_tensor(no_rows),
        prior=torch.as_tensor(prior))
    np.testing.assert_allclose(got.numpy(), want, rtol=LLR_RTOL,
                               atol=LLR_ATOL)
    hard = tp.Demapper(method, "qam", nbps, hard_out=True)(
        torch.as_tensor(y), torch.tensor(no))
    np.testing.assert_array_equal(
        hard.numpy(), np.asarray(jp.Demapper(method, "qam", nbps,
                                             hard_out=True)(
            jnp.asarray(y), no)))


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
