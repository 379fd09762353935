"""MIMO precoding, utilities and detectors of the PyTorch port against
the JAX package, on the same NumPy-drawn channels, noise covariances
and received vectors (64 resource elements, 4 receive antennas).

Tolerances, each relative to the largest magnitude of the output it
bounds:
- complex/real conversions and List2LLRSimple: exact (no arithmetic
  but the clip);
- precoders and linear detectors: LIN_RTOL, the f32 rounding of a 4 x 4
  Cholesky solve and a demapper (JAX's logaddexp and the LMMSE solve
  round differently from torch's), measured up to 9.8e-6;
- ML: max-log LLRs and hard decisions bit for bit in decisions, values
  within LIN_RTOL (the distances are sums of squares ordered
  differently); APP within LIN_RTOL;
- K-best: hard decisions identical, LLRs within LIN_RTOL (measured
  1.3e-6); with constructed ties (an identity channel, received
  vectors on the axes) identical decisions and LLR signs, which needs
  the lower index first among equal distances as XLA's TopK keeps it;
- EP: EP_RTOL. Its ten damped iterations feed each variance back into
  a Cholesky solve of an 8 x 8 system and a softmax over the PAM
  points; near convergence 1/var - 1/var_cav cancels, so f32 rounding
  differences of the solve grow (measured 8.3e-4);
- MMSE-PIC: PIC_RTOL; three self-iterations through the demapper with
  priors (measured 4.4e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.phy.mimo as jm
import sionna_tpu_torch.phy.mimo as tm
from sionna_tpu.phy.mapping import Constellation as JConstellation
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


LIN_RTOL = 2e-5
EP_RTOL = 2e-3
PIC_RTOL = 4e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.abs(want).max() + 1e-30)


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _system(seed, k, nbps, m=4, n=64, no=0.1):
    """(y, h, s) of n resource elements: y = h x + noise with the noise
    covariance s (no I plus a random rank-one interference)."""
    rng = np.random.default_rng(seed)
    h = _crandn(rng, n, m, k)
    pts = JConstellation("qam", nbps).points_host
    x = pts[rng.integers(0, len(pts), (n, k))]
    v = _crandn(rng, n, m, 1) * 0.3
    s = (no * np.eye(m) + v @ np.conj(np.swapaxes(v, -1, -2))).astype(
        np.complex64)
    noise = np.linalg.cholesky(s) @ _crandn(rng, n, m, 1)
    y = (h @ x[..., None] + noise)[..., 0].astype(np.complex64)
    return y, h, s


def test_complex_real_utils_match_jax():
    rng = np.random.default_rng(0)
    z = _crandn(rng, 5, 3)
    zm = _crandn(rng, 5, 3, 2)
    r = _crandn(rng, 5, 3, 3)
    for name, arg in (("complex2real_vector", z),
                      ("complex2real_matrix", zm),
                      ("complex2real_covariance", r)):
        got = getattr(tm, name)(_t(arg))
        want = np.asarray(getattr(jm, name)(arg))
        np.testing.assert_array_equal(got.numpy(), want)
        back = name.replace("complex2real", "real2complex")
        np.testing.assert_array_equal(
            getattr(tm, back)(got).numpy(),
            np.asarray(getattr(jm, back)(want)))
    for got, want in zip(tm.complex2real_channel(_t(z), _t(zm), _t(r)),
                         jm.complex2real_channel(z, zm, r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(
            tm.whiten_channel(*map(_t, _system(1, 2, 2))),
            jm.whiten_channel(*_system(1, 2, 2))):
        _close(got, want, LIN_RTOL)


def test_list2llr_simple_matches_jax():
    """Random candidate lists, some (stream, bit) with all candidates
    on one side (the clip value)."""
    rng = np.random.default_rng(2)
    dists = rng.uniform(0, 30, (7, 6)).astype(np.float32)
    inds = rng.integers(0, 16, (7, 6, 3))
    inds[0] = 5  # every candidate the same symbol: empty sets
    got = tm.List2LLRSimple(4)(None, None, _t(dists), _t(inds), None)
    want = jm.List2LLRSimple(4)(None, None, dists, inds, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)[0]).max() == 20.


@pytest.mark.parametrize("k", [2, 4])
def test_precoding_functions_match_jax(k):
    rng = np.random.default_rng(3)
    h = _crandn(rng, 6, k, 4)
    x = _crandn(rng, 6, k)
    for alpha in (0., 0.1):
        _close(tm.rzf_precoding_matrix(_t(h), alpha),
               jm.rzf_precoding_matrix(h, alpha), LIN_RTOL)
        xp, g = tm.rzf_precoder(_t(x), _t(h), alpha,
                                return_precoding_matrices=True)
        jxp, jg = jm.rzf_precoder(x, h, alpha,
                                  return_precoding_matrices=True)
        _close(xp, jxp, LIN_RTOL)
        _close(g, jg, LIN_RTOL)
    _close(tm.cbf_precoding_matrix(_t(h)), jm.cbf_precoding_matrix(h),
           LIN_RTOL)
    g = np.asarray(jm.rzf_precoding_matrix(h))
    for by_column in (True, False):
        np.testing.assert_array_equal(
            tm.flatten_precoding_mat(_t(g), by_column).numpy(),
            np.asarray(jm.flatten_precoding_mat(g, by_column)))
    vec = _crandn(rng, 3, 4)
    vec[1] = 0  # a zero vector stays zero
    power = np.array([1., 2., 0.5], np.float32)
    _close(tm.normalize_precoding_power(_t(vec), _t(power)),
           jm.normalize_precoding_power(vec, power), LIN_RTOL)
    _close(tm.grid_of_beams_dft_ula(4, 2), jm.grid_of_beams_dft_ula(4, 2),
           LIN_RTOL)
    _close(tm.grid_of_beams_dft(2, 4, 2, 1), jm.grid_of_beams_dft(2, 4, 2, 1),
           LIN_RTOL)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_grid_of_beams_device(device):
    """The grid-of-beams codebooks are built on ``device``, by default on
    ``config.device`` (here the meta device, which only records where a
    tensor would live), with JAX's values on the CPU."""
    torch_config.device = "meta"
    try:
        gob = tm.grid_of_beams_dft_ula(4, 2, device=device)
        gob2 = tm.grid_of_beams_dft(2, 4, 2, 1, device=device)
    finally:
        torch_config.device = "cpu"
    want = "meta" if device is None else device
    assert gob.device.type == gob2.device.type == want
    if device is not None:
        _close(gob, jm.grid_of_beams_dft_ula(4, 2), LIN_RTOL)
        _close(gob2, jm.grid_of_beams_dft(2, 4, 2, 1), LIN_RTOL)


@pytest.mark.parametrize("equalizer", ["lmmse", "zf", "mf"])
@pytest.mark.parametrize("output,method,hard", [
    ("bit", "app", False), ("bit", "maxlog", True),
    ("symbol", "app", False), ("symbol", "app", True)])
def test_linear_detector_matches_jax(equalizer, output, method, hard):
    y, h, s = _system(4, 3, 4)
    got = tm.LinearDetector(equalizer, output, method, "qam", 4,
                            hard_out=hard)(_t(y), _t(h), _t(s))
    want = jm.LinearDetector(equalizer, output, method, "qam", 4,
                             hard_out=hard)(y, h, s)
    if hard:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, LIN_RTOL)


@pytest.mark.parametrize("output", ["bit", "symbol"])
@pytest.mark.parametrize("method", ["app", "maxlog"])
@pytest.mark.parametrize("with_prior", [False, True])
def test_ml_detector_matches_jax(output, method, with_prior):
    """3 QPSK streams (64 joint vectors); the priors are LLRs per stream
    and bit, or symbol logits per stream and point."""
    nbps, k = 2, 3
    y, h, s = _system(5, k, nbps)
    prior = None
    if with_prior:
        d = nbps if output == "bit" else 2 ** nbps
        prior = np.random.default_rng(6).normal(
            0, 2, (y.shape[0], k, d)).astype(np.float32)
    args = (y, h, s) if prior is None else (y, h, s, prior)
    for hard in (False, True):
        got = tm.MaximumLikelihoodDetector(output, method, k, "qam", nbps,
                                           hard_out=hard)(*map(_t, args))
        want = np.asarray(jm.MaximumLikelihoodDetector(
            output, method, k, "qam", nbps, hard_out=hard)(*args))
        if hard:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got, want, LIN_RTOL)
            if output == "bit" and method == "maxlog":
                np.testing.assert_array_equal(got.numpy() > 0, want > 0)


def _kbest(pkg, output, k, use_real_rep, hard_out=False):
    return pkg.KBestDetector(output, 2, k, "qam", 4, hard_out=hard_out,
                             use_real_rep=use_real_rep)


@pytest.mark.parametrize("use_real_rep", [False, True])
def test_kbest_matches_jax(use_real_rep):
    """2 16-QAM streams, k=8 of 256 paths (complex) or of 4^4 in the
    real representation."""
    y, h, s = _system(7, 2, 4, no=0.05)
    got = _kbest(tm, "bit", 8, use_real_rep)(_t(y), _t(h), _t(s))
    want = np.asarray(_kbest(jm, "bit", 8, use_real_rep)(y, h, s))
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    _close(got, want, LIN_RTOL)
    got = _kbest(tm, "symbol", 8, use_real_rep, True)(_t(y), _t(h), _t(s))
    want = _kbest(jm, "symbol", 8, use_real_rep, True)(y, h, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_real_rep", [False, True])
def test_kbest_ties_match_jax(use_real_rep):
    """An identity channel and received vectors on the axes of the
    constellation plane (0 and the PAM values): candidates mirrored
    across an axis have bitwise equal distances in both packages, so
    many paths tie exactly at each level, and the equal column norms
    tie the stream ordering. The list kept, its order and so the
    decisions depend on keeping the lower index first among equal
    distances and norms; the LLRs have the same signs (exactly 0 where bit
    0 and bit 1 tie) and agree to rounding. (Distances that tie only in
    exact arithmetic, such as those of a midpoint between two points,
    round differently in the two packages.)"""
    pts = np.unique(np.round(np.real(JConstellation("qam", 4).points_host),
                             6))
    vals = np.concatenate([[0.], pts]).astype(np.float32)
    y1 = np.concatenate([vals + 0j, 1j * vals]).astype(np.complex64)
    y = np.stack(np.meshgrid(y1, y1[::-1], indexing="ij"), -1).reshape(-1, 2)
    n = y.shape[0]
    h = np.broadcast_to(np.eye(2, dtype=np.complex64), (n, 2, 2)).copy()
    s = h.copy()
    for k in (3, 8):
        got = _kbest(tm, "bit", k, use_real_rep)(_t(y), _t(h), _t(s))
        want = np.asarray(_kbest(jm, "bit", k, use_real_rep)(y, h, s))
        np.testing.assert_array_equal(np.sign(got.numpy()), np.sign(want))
        assert np.sum(want == 0) > 0
        _close(got, want, LIN_RTOL)
        got = _kbest(tm, "symbol", k, use_real_rep, True)(_t(y), _t(h),
                                                          _t(s))
        want = _kbest(jm, "symbol", k, use_real_rep, True)(y, h, s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("output,hard", [("bit", False), ("bit", True),
                                         ("symbol", False),
                                         ("symbol", True)])
def test_ep_detector_matches_jax(output, hard):
    """3 16-QAM streams, 10 iterations, beta 0.9."""
    y, h, s = _system(8, 3, 4)
    got = tm.EPDetector(output, 4, hard_out=hard)(_t(y), _t(h), _t(s))
    want = np.asarray(jm.EPDetector(output, 4, hard_out=hard)(y, h, s))
    if hard:
        assert np.mean(got.numpy() != want) == 0
    else:
        _close(got, want, EP_RTOL)


@pytest.mark.parametrize("output", ["bit", "symbol"])
@pytest.mark.parametrize("with_prior", [False, True])
def test_mmse_pic_detector_matches_jax(output, with_prior):
    """3 16-QAM streams, 3 self-iterations, APP demapping, with and
    without priors (LLRs, or symbol logits)."""
    y, h, s = _system(9, 3, 4)
    prior = None
    if with_prior:
        d = 4 if output == "bit" else 16
        prior = np.random.default_rng(10).normal(
            0, 2, (y.shape[0], 3, d)).astype(np.float32)
    kw = dict(demapping_method="app", num_iter=3, constellation_type="qam",
              num_bits_per_symbol=4)
    got = tm.MMSEPICDetector(output, **kw)(
        _t(y), _t(h), _t(s), None if prior is None else _t(prior))
    want = jm.MMSEPICDetector(output, **kw)(y, h, s, prior)
    _close(got, want, PIC_RTOL)
