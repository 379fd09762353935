"""Channel blocks of the PyTorch port: the OFDM frequency response and
its application against the JAX package on JAX-drawn channels (to f32
rounding), and the TDL model by its statistics on the torch generator
(power normalisation, delay-spread scaling, Doppler autocorrelation,
LoS K-factor, spatial correlation), as tests/test_tr38901.py holds the
JAX model."""

import numpy as np
import pytest
import torch
from scipy.special import j0

import jax

import sionna_tpu.phy.channel as jch
import sionna_tpu.phy.ofdm as jofdm
from sionna_tpu.phy.channel.tr38901 import TDL as JTDL
import sionna_tpu.phy.channel.utils as jcu
import sionna_tpu_torch.phy.channel.utils as tcu
from sionna_tpu_torch.phy.channel import (ApplyOFDMChannel, OFDMChannel,
                                          cir_to_ofdm_channel,
                                          subcarrier_frequencies)
from sionna_tpu_torch.phy.channel.tr38901 import TDL
from sionna_tpu_torch.phy.constants import PI, SPEED_OF_LIGHT
from sionna_tpu_torch.phy.ofdm import (ResourceGrid, tdl_freq_cov_mat,
                                       tdl_time_cov_mat)
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

# Unit roundoff of f32.
F32_U = 2.0 ** -24
RG = dict(num_ofdm_symbols=14, fft_size=64, subcarrier_spacing=30e3,
          cyclic_prefix_length=16, pilot_pattern="kronecker",
          pilot_ofdm_symbol_indices=[2, 11])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("normalize", [False, True])
def test_cir_to_ofdm_channel_matches_jax(normalize):
    """On a and tau drawn by JAX's TDL-A (2 rx antennas)."""
    jtdl = JTDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=30,
                num_rx_ant=2)
    fs = 1 / jofdm.ResourceGrid(**RG).ofdm_symbol_duration
    a, tau = jax.jit(lambda key: jtdl(6, 14, fs, key=key))(
        jax.random.PRNGKey(0))
    a, tau = np.array(a), np.array(tau)
    freqs = subcarrier_frequencies(64, 30e3)
    np.testing.assert_array_equal(
        freqs.numpy(), np.asarray(jch.subcarrier_frequencies(64, 30e3)))
    got = cir_to_ofdm_channel(freqs, torch.as_tensor(a), torch.as_tensor(tau),
                              normalize=normalize)
    want = np.asarray(jax.jit(lambda a, t: jch.cir_to_ofdm_channel(
        jch.subcarrier_frequencies(64, 30e3), a, t, normalize=normalize))(
            a, tau))
    assert got.shape == want.shape == (6, 1, 2, 1, 1, 14, 64)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 _freq_tol(freqs.numpy(), a, tau, normalize))


def _freq_tol(freqs, a, tau, normalize):
    """Bound on |port - JAX| for h(f) = sum over P paths of
    a_m exp(-j phi_m), phi_m = 2 pi f tau_m, both summed in f32: torch by
    a matrix product, JAX by a reduction, in other orders and with other
    cos/sin approximations (which also differ between CPUs). Each is
    within (P + 2 + |phi|_max) u sum_m |a_m| of the exact sum (the
    dot-product rounding bound, one ULP each for the phase and for
    cos/sin), so the two differ by at most twice that. Normalised: the
    same over the normalising constant, plus a few ULP of the result."""
    a64, tau64 = a.astype(np.complex128), tau.astype(np.float64)
    phi_max = np.abs(2 * np.pi * freqs).max() * np.abs(tau64).max()
    n_paths = a.shape[-2]
    s = np.abs(a64).sum(axis=-2)[..., None]  # [b, rx, rxa, tx, txa, T, 1]
    tol = 2 * (n_paths + 2 + phi_max) * F32_U * s
    if normalize:
        tau_b = tau64[:, :, None, :, None, :, None, None]
        h = (a64[..., None]
             * np.exp(-2j * np.pi * freqs * tau_b)).sum(axis=-3)
        c = np.sqrt(np.mean(np.abs(h) ** 2, axis=(2, 4, 5, 6), keepdims=True))
        tol = tol / c + 8 * F32_U * np.abs(h) / c
    return np.broadcast_to(tol, a.shape[:-2] + (a.shape[-1], len(freqs)))


def test_apply_ofdm_channel_matches_jax():
    rng = np.random.default_rng(0)
    h = (rng.normal(size=(3, 1, 2, 2, 1, 14, 64))
         + 1j * rng.normal(size=(3, 1, 2, 2, 1, 14, 64))).astype(np.complex64)
    x = (rng.normal(size=(3, 2, 1, 14, 64))
         + 1j * rng.normal(size=(3, 2, 1, 14, 64))).astype(np.complex64)
    got = ApplyOFDMChannel()(torch.as_tensor(x), torch.as_tensor(h))
    want = np.asarray(jax.jit(jch.ApplyOFDMChannel())(x, h))
    assert got.shape == want.shape == (3, 1, 2, 14, 64)
    # one complex product and a sum of two per RE: 1 ULP of |y| <= ~10
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_ofdm_channel_noise_and_channel():
    rg = ResourceGrid(**RG)
    tdl = TDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=3)
    chan = OFDMChannel(tdl, rg, normalize_channel=True, return_channel=True)
    x = torch.ones((256, 1, 1, 14, 64), dtype=torch.complex64)
    y, h = chan(x, 0.5, generator=_gen(0))
    assert y.shape == (256, 1, 1, 14, 64) and h.shape == (256, 1, 1, 1, 1,
                                                          14, 64)
    # normalize_channel: unit mean power per block
    p = torch.mean(torch.abs(h) ** 2, dim=(2, 4, 5, 6))
    np.testing.assert_allclose(p.numpy(), 1.0, rtol=1e-5)
    noise = y - h[:, :, :, 0, 0]
    assert float(torch.mean(torch.abs(noise) ** 2)) == pytest.approx(
        0.5, rel=0.02)
    # the same generator state draws the same channel and noise
    y2, _ = chan(x, 0.5, generator=_gen(0))
    assert torch.equal(y, y2)
    quiet = OFDMChannel(tdl, rg, add_awgn=False, return_channel=True)
    yq, hq = quiet(x, 0.5, generator=_gen(1))
    assert torch.equal(yq, hq[:, :, :, 0, 0])


@pytest.mark.parametrize("model", ["A", "C", "D"])
def test_tdl_power_normalization_and_tables(model):
    tdl, jtdl = TDL(model, 100e-9, 3.5e9), JTDL(model, 100e-9, 3.5e9)
    a, tau = tdl(2000, 1, 15e3 * 14, generator=_gen(2))
    assert a.shape == (2000, 1, 1, 1, 1, tdl.num_clusters, 1)
    assert tau.shape == (2000, 1, 1, tdl.num_clusters)
    p = float(torch.mean(torch.sum(torch.abs(a[..., 0]) ** 2, dim=-1)))
    assert p == pytest.approx(1.0, rel=0.05)
    # the model tables exported from JAX check equal
    exported = {"delays": jtdl._delays, "mean_powers": jtdl._mean_powers}
    if jtdl.los:
        exported["los_power"] = np.asarray(jtdl._los_power)
    load_numpy_state(tdl, exported)
    chan = OFDMChannel(tdl, ResourceGrid(**RG))
    load_numpy_state(chan, {f"gen.channel_model.{k}": v
                            for k, v in exported.items()})
    np.testing.assert_array_equal(tdl.delays, jtdl.delays)
    np.testing.assert_array_equal(tdl.mean_powers, jtdl.mean_powers)
    np.testing.assert_array_equal(tau[0, 0, 0].numpy(),
                                  jtdl.delays.astype(np.float32))
    with pytest.raises(ValueError, match="delays"):
        load_numpy_state(tdl, {"delays": jtdl._delays * 2})


def test_tdl_delay_spread_scaling():
    ds = 250e-9
    tdl = TDL("B", ds, 3.5e9)
    _, tau = tdl(4, 1, 15e3, generator=_gen(0))
    tau = tau[0, 0, 0].numpy().astype(np.float64)
    p = np.asarray(tdl.mean_powers)
    mean_delay = np.sum(p * tau) / p.sum()
    rms = np.sqrt(np.sum(p * (tau - mean_delay) ** 2) / p.sum())
    assert rms == pytest.approx(ds, rel=1e-3)


def test_tdl_doppler_autocorrelation():
    """Clarke's model: R(dt) = J0(2 pi fd dt)."""
    speed, fc, fs = 30.0, 3.5e9, 10000.0
    fd = speed / SPEED_OF_LIGHT * fc
    tdl = TDL("A", 100e-9, fc, min_speed=speed, max_speed=speed,
              num_sinusoids=40)
    a, _ = tdl(800, 32, fs, generator=_gen(3))
    a = a[:, 0, 0, 0, 0].numpy()  # [batch, taps, time]
    lags = np.arange(16)
    ac = np.array([np.mean(a[..., :32 - lag] * np.conj(a[..., lag:])).real
                   / np.mean(np.abs(a[..., :32 - lag]) ** 2)
                   for lag in lags])
    np.testing.assert_allclose(ac, j0(2 * PI * fd * lags / fs), atol=0.06)


def test_tdl_los_k_factor():
    """TDL-D: the first tap is Rician with the 13.3 dB K-factor; its
    normalised fourth moment E|h|^4 / E|h|^2^2 = (2 + 4K + K^2)/(1 + K)^2
    (2 for Rayleigh)."""
    tdl = TDL("D", 100e-9, 3.5e9, min_speed=3, max_speed=3)
    assert tdl.los
    k = float(tdl.k_factor)
    assert 10 * np.log10(k) == pytest.approx(13.3, abs=0.2)
    a, _ = tdl(4000, 4, 1e4, generator=_gen(4))
    p0 = torch.abs(a[:, 0, 0, 0, 0, 0]).double() ** 2
    assert float(p0.mean()) == pytest.approx(tdl.mean_powers[0], rel=0.02)
    m4 = float((p0 ** 2).mean() / p0.mean() ** 2)
    assert m4 == pytest.approx((2 + 4 * k + k * k) / (1 + k) ** 2, abs=0.03)


def test_tdl_spatial_correlation():
    """Receive correlation (rx_corr_mat) and full spatial correlation
    (spatial_corr_mat) show up in the channels' empirical covariance."""
    r = np.array([[1.0, 0.6], [0.6, 1.0]])
    for kw in (dict(rx_corr_mat=r), dict(spatial_corr_mat=r)):
        tdl = TDL("A", 100e-9, 3.5e9, num_rx_ant=2, **kw)
        a, _ = tdl(3000, 1, 1e4, generator=_gen(5))
        h = a[:, 0, :, 0, 0, :, 0].numpy()  # [batch, rx_ant, taps]
        cov = np.einsum("bit,bjt->ij", h, np.conj(h)) / h.shape[0]
        np.testing.assert_allclose(cov, r, atol=0.06)


def _tdl_cir(num_time_steps):
    """a, tau drawn by JAX's TDL-A (2 rx antennas), as NumPy."""
    jtdl = JTDL("A", 100e-9, 3.5e9, min_speed=3, max_speed=30,
                num_rx_ant=2)
    a, tau = jax.jit(lambda key: jtdl(3, num_time_steps, 20e6, key=key))(
        jax.random.PRNGKey(1))
    return np.array(a), np.array(tau)


def test_time_vectors_and_angles_match_jax():
    # JAX's linspace lerps start and stop (its middle sample of
    # -7..6 is 1e-15, not 0): one f32 ULP of the largest value
    for n, dt in ((14, 1e-6), (15, 3.3e-8)):
        for got, want in zip(tcu.time_frequency_vector(n, dt),
                             jcu.time_frequency_vector(n, dt)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=F32_U * np.abs(want).max())
    assert tcu.time_lag_discrete_time_channel(20e6) == \
        jcu.time_lag_discrete_time_channel(20e6)
    assert tcu.time_lag_discrete_time_channel(1e8, 1e-6) == \
        jcu.time_lag_discrete_time_channel(1e8, 1e-6)
    x = np.array([-400., -30.5, 0., 45., 359.9, 721.], np.float32)
    np.testing.assert_array_equal(tcu.deg_2_rad(torch.as_tensor(x)).numpy(),
                                  np.asarray(jcu.deg_2_rad(x)))
    np.testing.assert_array_equal(tcu.rad_2_deg(torch.as_tensor(x)).numpy(),
                                  np.asarray(jcu.rad_2_deg(x)))
    np.testing.assert_array_equal(
        tcu.wrap_angle_0_360(torch.as_tensor(x)).numpy(),
        np.asarray(jcu.wrap_angle_0_360(x)))


@pytest.mark.parametrize("normalize", [False, True])
def test_cir_to_time_channel_matches_jax(normalize):
    """On a and tau drawn by JAX's TDL-A: sinc taps summed over the
    paths, f32 (torch's and XLA's sinc round alike to a few ULP; the sum
    of ~23 paths adds a few more)."""
    a, tau = _tdl_cir(5)
    l_min, l_max = jcu.time_lag_discrete_time_channel(20e6)
    got = tcu.cir_to_time_channel(20e6, torch.as_tensor(a),
                                  torch.as_tensor(tau), l_min, l_max,
                                  normalize=normalize)
    want = np.asarray(jcu.cir_to_time_channel(20e6, a, tau, l_min, l_max,
                                              normalize=normalize))
    assert got.shape == want.shape == a.shape[:5] + (5, l_max - l_min + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=64 * F32_U * np.abs(want).max())


def test_time_to_ofdm_channel_matches_jax():
    """The taps at each symbol start, zero-padded and FFT'd: torch's
    pocketfft against XLA:CPU's FFT, f32."""
    kw = dict(RG, fft_size=32, cyclic_prefix_length=4)
    jrg, trg = jofdm.ResourceGrid(**kw), ResourceGrid(**kw)
    rng = np.random.default_rng(2)
    h_t = (rng.normal(size=(2, 1, 1, 1, 1, 14 * 36, 9))
           + 1j * rng.normal(size=(2, 1, 1, 1, 1, 14 * 36, 9))).astype(
               np.complex64)
    got = tcu.time_to_ofdm_channel(torch.as_tensor(h_t), trg, -3)
    want = np.asarray(jcu.time_to_ofdm_channel(h_t, jrg, -3))
    assert got.shape == want.shape == (2, 1, 1, 1, 1, 14, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=64 * F32_U * np.abs(want).max())


def test_correlation_matrices_match_jax():
    for a in (0.5, 0.9 * np.exp(0.3j), np.array([0.2, 0.7j], np.complex64)):
        got = tcu.exp_corr_mat(torch.as_tensor(a), 4)
        want = np.asarray(jcu.exp_corr_mat(a, 4))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=8 * F32_U)
    for phi in (30., np.array([-10., 45., 80.], np.float32)):
        got = tcu.one_ring_corr_mat(torch.as_tensor(phi), 4)
        want = np.asarray(jcu.one_ring_corr_mat(phi, 4))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=64 * F32_U)
    # correlation matrices: Hermitian, unit diagonal
    r = tcu.exp_corr_mat(torch.tensor(0.9 * np.exp(0.3j)), 5).numpy()
    np.testing.assert_allclose(r, np.conj(r.T), atol=1e-7)
    np.testing.assert_allclose(np.diag(r), 1, atol=1e-7)


def test_tdl_covariances_match_jax():
    """Host NumPy in both packages from the same JSON tables: equal."""
    for model in ("A", "B", "C", "D", "E"):
        np.testing.assert_array_equal(
            tdl_freq_cov_mat(model, 30e3, 16, 100e-9),
            jofdm.tdl_freq_cov_mat(model, 30e3, 16, 100e-9))
        np.testing.assert_array_equal(
            tdl_time_cov_mat(model, 3 / 3.6, 3.5e9, 3.54e-5, 14),
            jofdm.tdl_time_cov_mat(model, 3 / 3.6, 3.5e9, 3.54e-5, 14))
    r = tdl_freq_cov_mat("A", 30e3, 16, 100e-9)
    np.testing.assert_allclose(np.diag(r), 1)  # normalized power
    with pytest.raises(ValueError):
        tdl_freq_cov_mat("F", 30e3, 16, 100e-9)
