"""TR 38.901 antennas, the step-11 coefficient generator and the CDL
models of the PyTorch port against the JAX package.

- Element positions and polarization indices are computed by the same
  NumPy code: equal. Field patterns to f32 rounding of the pattern
  (the JAX package promotes them to float64, as the port does).
- The CDL, given the JAX package's own draws (velocities, the random
  coupling permutations and the ray phases, recomputed here from the
  same key splits as ``sionna_tpu/phy/channel/tr38901/cdl.py`` and
  ``channel_coefficients.py`` make them), matches JAX's CIR to rounding
  (CIR_RTOL of the largest coefficient) and its delays exactly; so does
  the coefficient generator with sub-clusters on a random topology.
- The port's own draws are held by statistics with omnidirectional
  antennas: unit mean power, the per-cluster power against the model's
  powers, the Rician first tap of CDL-D/E (its K-factor through the
  normalised fourth moment), the delay spread.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.channel.tr38901 as J
import sionna_tpu.phy.channel.tr38901.channel_coefficients as jcc
import sionna_tpu_torch.phy.channel.tr38901 as T
from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.constants import PI
from sionna_tpu_torch.phy.ofdm import ResourceGrid
from sionna_tpu_torch.phy.utils import load_numpy_state

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


# Field patterns: sqrt of 10^(x/10) in f32, then float64 products: a
# few f32 ULP.
FIELD_RTOL = 4 * 2.0 ** -23
# A CIR coefficient sums 20 rays, each a product of about ten rounded
# factors (f32 cos/sin of arguments up to ~2 pi, which XLA and libm
# approximate differently); measured below 4.5e-7 of the largest
# coefficient: 2^-17 leaves a margin of 17.
CIR_RTOL = 2.0 ** -17

ARRAYS = [  # (num_rows, num_cols, polarization, type, pattern)
    (1, 1, "single", "V", "omni"),
    (2, 2, "single", "H", "38.901"),
    (1, 2, "dual", "cross", "38.901"),
    (2, 3, "dual", "VH", "38.901"),
]


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrays(pkg, ut_cols=1, bs_cols=2):
    """(ut, bs) cross-polarized 38.901 arrays of one row."""
    return tuple(pkg.AntennaArray(1, c, "dual", "cross", "38.901", 3.5e9)
                 for c in (ut_cols, bs_cols))


@pytest.mark.parametrize("cfg", ARRAYS)
def test_antenna_arrays_match_jax(cfg):
    rows, cols, pol, ptype, pattern = cfg
    ja = J.AntennaArray(rows, cols, pol, ptype, pattern, 3.5e9)
    ta = T.AntennaArray(rows, cols, pol, ptype, pattern, 3.5e9)
    np.testing.assert_array_equal(ta.ant_pos, ja.ant_pos)
    np.testing.assert_array_equal(ta.ant_pos_pol1, ja.ant_pos_pol1)
    np.testing.assert_array_equal(ta.ant_ind_pol1, ja.ant_ind_pol1)
    assert ta.num_ant == ja.num_ant
    elements = [(ta.ant_pol1, ja.ant_pol1)]
    if pol == "dual":
        np.testing.assert_array_equal(ta.ant_ind_pol2, ja.ant_ind_pol2)
        np.testing.assert_array_equal(ta.ant_pos_pol2, ja.ant_pos_pol2)
        elements.append((ta.ant_pol2, ja.ant_pol2))
    # the structure check takes JAX's positions and refuses others
    load_numpy_state(ta, {"ant_pos": ja.ant_pos,
                          "ant_ind_pol1": ja.ant_ind_pol1})
    with pytest.raises(ValueError, match="ant_pos"):
        load_numpy_state(ta, {"ant_pos": ja.ant_pos + 1e-3})
    # field patterns over a grid of angles
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, PI, 200).astype(np.float32)
    phi = rng.uniform(-PI, PI, 200).astype(np.float32)
    for te, je in elements:
        pt = te.radiation_pattern(_t(theta), _t(phi)).numpy()
        pj = np.asarray(je.radiation_pattern(theta, phi))
        np.testing.assert_allclose(pt, pj, rtol=FIELD_RTOL)
        for ft, fj in zip(te.field(_t(theta), _t(phi)),
                          je.field(theta, phi)):
            assert ft.dtype == torch.float64 and fj.dtype == np.float64
            np.testing.assert_allclose(ft.numpy(), np.asarray(fj),
                                       rtol=FIELD_RTOL,
                                       atol=FIELD_RTOL * np.abs(fj).max())


def _jax_draws(jcdl, key, batch, min_speed, max_speed):
    """The draws of JAX's ``CDL.__call__`` under ``key``, as the port's
    ``CDL.cir`` takes them."""
    k_v, k_shuf, k_cir = jax.random.split(key, 3)
    kv1, kv2, kv3 = jax.random.split(k_v, 3)
    f32 = jnp.float32
    v_r = jax.random.uniform(kv1, (batch, 1), f32, min_speed, max_speed)
    v_phi = jax.random.uniform(kv2, (batch, 1), f32, 0., 2. * PI)
    v_theta = jax.random.uniform(kv3, (batch, 1), f32, 0., PI)
    shape = (batch, 1, 1, jcdl.num_clusters, J.CDL.NUM_RAYS)
    perms = [_t(jnp.argsort(jax.random.normal(k, shape), axis=-1))
             for k in jax.random.split(k_shuf, 4)]
    phi = jax.random.uniform(k_cir, shape + (4,), f32, -PI, PI)
    return _t(v_r), _t(v_phi), _t(v_theta), perms, _t(phi)


@pytest.mark.parametrize("model,direction", [
    ("A", "uplink"), ("B", "downlink"), ("C", "uplink"),
    ("D", "downlink"), ("E", "uplink")])
def test_cdl_cir_matches_jax_given_its_draws(model, direction):
    """Cross-polarized 38.901 arrays (2 x 4 antennas), speeds 3-30 m/s,
    5 time steps."""
    batch, steps, fs, key = 3, 5, 30e3, jax.random.PRNGKey(3)
    jcdl = J.CDL(model, 100e-9, 3.5e9, *_arrays(J), direction,
                 min_speed=3., max_speed=30.)
    tcdl = T.CDL(model, 100e-9, 3.5e9, *_arrays(T), direction,
                 min_speed=3., max_speed=30.)
    a, tau = jcdl(batch, steps, fs, key=key)
    a, tau = np.asarray(a), np.asarray(tau)
    ta, ttau = tcdl.cir(steps, fs, *_jax_draws(jcdl, key, batch, 3., 30.))
    assert ta.shape == a.shape and ta.dtype == torch.complex64
    np.testing.assert_array_equal(ttau.numpy(), tau)
    np.testing.assert_array_less(np.abs(ta.numpy() - a),
                                 CIR_RTOL * np.abs(a).max())
    # the port's own draws give the same shapes and delays
    a2, tau2 = tcdl(batch, steps, fs, generator=torch.Generator())
    assert a2.shape == a.shape
    np.testing.assert_array_equal(tau2.numpy(), tau)


def test_coefficient_generator_subclusters_match_jax():
    """Step 11 with sub-clusters (the two strongest clusters split in
    three) on a random topology: two transmitters, the receiver moving,
    one link in LoS, given the same phases."""
    rng = np.random.default_rng(1)
    b, tx, rx, cl, rays, steps = 2, 2, 1, 5, 20, 4
    tx_arr = (J.PanelArray(1, 1, "dual", "cross", "38.901", 3.5e9),
              T.PanelArray(1, 1, "dual", "cross", "38.901", 3.5e9))
    rx_arr = (J.AntennaArray(1, 2, "single", "V", "38.901", 3.5e9),
              T.AntennaArray(1, 2, "single", "V", "38.901", 3.5e9))
    f32 = np.float32

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(f32)

    angles = dict(aoa=u(-PI, PI, b, tx, rx, cl, rays),
                  aod=u(-PI, PI, b, tx, rx, cl, rays),
                  zoa=u(0.1, PI - 0.1, b, tx, rx, cl, rays),
                  zod=u(0.1, PI - 0.1, b, tx, rx, cl, rays))
    powers = u(0.1, 1., b, tx, rx, cl)
    rays_np = dict(delays=u(0, 1e-6, b, tx, rx, cl),
                   powers=powers / powers.sum(-1, keepdims=True),
                   xpr=u(5., 20., b, tx, rx, cl, rays), **angles)
    topo_np = dict(velocities=u(-3, 3, b, rx, 3), moving_end="rx",
                   los_aoa=u(-PI, PI, b, tx, rx),
                   los_aod=u(-PI, PI, b, tx, rx),
                   los_zoa=u(0.5, 2.5, b, tx, rx),
                   los_zod=u(0.5, 2.5, b, tx, rx),
                   los=np.array([[[True], [False]], [[False], [True]]]),
                   distance_3d=u(10, 100, b, tx, rx),
                   tx_orientations=u(-1, 1, b, tx, 3),
                   rx_orientations=u(-1, 1, b, rx, 3))
    k_factor = u(1., 10., b, tx, rx)
    c_ds = u(1e-9, 5e-9, b, tx, rx)
    phi = u(-PI, PI, b, tx, rx, cl, rays, 4)
    t = (np.arange(steps) / 1e4).astype(f32)

    jgen = jcc.ChannelCoefficientsGenerator(3.5e9, tx_arr[0], rx_arr[0],
                                            subclustering=True)
    tgen = T.ChannelCoefficientsGenerator(3.5e9, tx_arr[1], rx_arr[1],
                                          subclustering=True)
    h, delays = jgen._step_11(
        jnp.asarray(phi), jcc.Topology(**topo_np), k_factor,
        J.Rays(**rays_np), jnp.asarray(t), c_ds)

    def tt(d):
        return {k: v if isinstance(v, str) else _t(v) for k, v in d.items()}

    th, tdelays = tgen._step_11(_t(phi), T.Topology(**tt(topo_np)),
                                _t(k_factor), T.Rays(**tt(rays_np)), _t(t),
                                _t(c_ds))
    h, delays = np.asarray(h), np.asarray(delays)
    assert th.shape == h.shape == (b, tx, rx, cl + 4, 2, 2, steps)
    np.testing.assert_array_equal(tdelays.numpy(), delays)
    np.testing.assert_array_less(np.abs(th.numpy() - h),
                                 CIR_RTOL * np.abs(h).max())


def _omni_cdl(model, direction="uplink", **kw):
    ant = T.Antenna("single", "V", "omni", 3.5e9)
    return T.CDL(model, 100e-9, 3.5e9, ant, ant, direction, **kw)


@pytest.mark.parametrize("model", ["B", "C"])
def test_cdl_power_per_cluster(model):
    """With omnidirectional, vertically polarized antennas each cluster's
    mean power is its table power (a sum of 20 unit-power rays with
    random phases, scaled by sqrt(P / 20)), and they sum to 1. 4000
    draws: the relative standard error of each mean is about 1.6 %."""
    cdl = _omni_cdl(model)
    a, tau = cdl(4000, 1, 30e3, generator=torch.Generator().manual_seed(2))
    # the clusters come out sorted by delay
    order = np.argsort(cdl.delays, kind="stable")
    p = torch.mean(torch.abs(a[:, 0, 0, 0, 0, :, 0]).double() ** 2, dim=0)
    np.testing.assert_allclose(p.numpy(), cdl.powers[order], rtol=0.08)
    assert float(p.sum()) == pytest.approx(1.0, rel=0.03)
    # the delay spread of the scaled delays
    tau = tau[0, 0, 0].double().numpy()
    w = cdl.powers[order]
    mean = np.sum(w * tau)
    assert np.sqrt(np.sum(w * (tau - mean) ** 2)) == pytest.approx(
        100e-9, rel=1e-2)


@pytest.mark.parametrize("model", ["D", "E"])
def test_cdl_los_k_factor(model):
    """CDL-D/E: the first tap is Rician (its specular part of power
    K / (K + 1)); its mean power is the combined table power and its
    normalised fourth moment E|h|^4 / E|h|^2^2 = (2 + 4K + K^2) /
    (1 + K)^2, K the model's K-factor (the diffuse part sums 20 rays:
    its own fourth moment is 2 - 1/20, within the tolerance)."""
    cdl = _omni_cdl(model, min_speed=3.)
    k = float(cdl.k_factor)
    assert 10 * np.log10(k) == pytest.approx(
        {"D": 13.3, "E": 22.0}[model], abs=0.2)
    a, _ = cdl(4000, 4, 1e4, generator=torch.Generator().manual_seed(4))
    p0 = torch.abs(a[:, 0, 0, 0, 0, 0]).double() ** 2
    assert float(p0.mean()) == pytest.approx(cdl.powers[0], rel=0.02)
    m4 = float((p0 ** 2).mean() / p0.mean() ** 2)
    assert m4 == pytest.approx((2 + 4 * k + k * k) / (1 + k) ** 2, abs=0.03)


@pytest.mark.parametrize("model,direction", [("B", "uplink"),
                                             ("D", "downlink")])
def test_cdl_structure_checks(model, direction):
    """``load_numpy_state`` holds the CDL's tables (normalised delays,
    powers, ray angles, XPR, K-factor, LoS angles) and its arrays'
    element positions to those the JAX package built, and refuses
    others; so does an OFDMChannel around it."""
    jcdl = J.CDL(model, 100e-9, 3.5e9, *_arrays(J), direction)
    tcdl = T.CDL(model, 100e-9, 3.5e9, *_arrays(T), direction)
    exported = {k: np.asarray(getattr(jcdl, "_" + k)) for k in (
        "delays", "powers", "aoa", "aod", "zoa", "zod", "xpr", "k_factor")}
    if jcdl.los:
        exported.update({k: np.asarray(getattr(jcdl, "_" + k)) for k in (
            "los_aoa", "los_aod", "los_zoa", "los_zod")})
    tx, rx = (jcdl._tx_array, jcdl._rx_array)
    exported.update({"tx_array.ant_pos": tx.ant_pos,
                     "rx_array.ant_pos": rx.ant_pos})
    load_numpy_state(tcdl, exported)
    rg = ResourceGrid(num_ofdm_symbols=2, fft_size=12,
                      subcarrier_spacing=30e3, num_tx=1)
    load_numpy_state(OFDMChannel(tcdl, rg), {
        f"gen.channel_model.{k}": v for k, v in exported.items()})
    assert tcdl.k_factor == jcdl.k_factor
    np.testing.assert_array_equal(tcdl.powers, np.asarray(jcdl.powers))
    np.testing.assert_array_equal(tcdl.delays, np.asarray(jcdl.delays))
    for name in ("aoa", "xpr", "rx_array.ant_pos"):
        with pytest.raises(ValueError, match=name):
            load_numpy_state(tcdl, {name: exported[name] + 1e-3})
