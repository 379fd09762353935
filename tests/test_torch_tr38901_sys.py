"""TR 38.901 system-level channel models of the PyTorch port against the
JAX package: the 3GPP topology helpers, the UMa/UMi/RMa scenarios, the
LSP and ray generators and ``SystemLevelChannel``.

- Bit-exact: the topology helpers and the scenarios' LoS and indoor
  states from the same ``config.seed`` (both packages draw from NumPy's
  ``config.np_rng`` with the same calls in the same order); the
  scenarios' host state (LoS probability, basic pathloss, LSP log means
  and standard deviations, ZOD offsets) and the correlation matrices'
  square roots, which both packages compute with the same NumPy code.
- To f32 rounding: the LSPs, the pathloss with the O2I loss (float64 in
  both packages, from a NumPy float64 scalar), the rays and the
  channel's ``a`` and ``tau``, given the JAX package's draws (recomputed
  here from its key splits: ``system_level_channel.py:106``,
  ``rays.py:60``, ``lsp.py:77``).
- By statistics: the port's own draws, as ``tests/test_tr38901_sys.py``
  holds JAX's.

The JAX channels are jitted (one compile per model), at one site, 3 UTs
and 2 time steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.channel as JC
import sionna_tpu.phy.channel.tr38901 as J
from sionna_tpu.phy import config as jax_config
import sionna_tpu_torch.phy.channel as TC
import sionna_tpu_torch.phy.channel.tr38901 as T
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)
CARRIER = 3.5e9
PI = np.pi
# An LSP is 10^x of a log-domain value x (|x| < 8) that sums seven f32
# products in another order: a few ULP of x (2^-20 at |x| in [4, 8)),
# times ln 10 in relative terms: 2^-16 leaves a margin of about 7 ULP
LSP_RTOL = 2.0 ** -16
# a CIR coefficient: products and sums of ~20 rounded rays, as
# tests/test_torch_cdl.py's CIR_RTOL, of the largest coefficient
CIR_RTOL = 2.0 ** -17
# ray angles [rad] and delays [s]: of the largest value
RAY_RTOL = 2.0 ** -19


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _seed(s):
    jax_config.seed = s
    torch_config.seed = s


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrays(pkg):
    """(ut, bs): an omni UT and a dual-polarized 2 x 2 38.901 BS panel."""
    ut = pkg.PanelArray(1, 1, "single", "V", "omni", CARRIER)
    bs = pkg.PanelArray(2, 2, "dual", "VH", "38.901", CARRIER)
    return ut, bs


# ----------------------------------------------------------------------
# Topology helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("drop_uts_in_sector", (4, 6, 10., 200., 10., 1.5)),
    ("gen_single_sector_topology", (3, 5, "umi")),
    ("gen_single_sector_topology", (2, 4, "uma")),
    ("gen_single_sector_topology", (2, 4, "rma")),
    ("gen_single_sector_topology_interferers", (2, 4, 3, "umi")),
    ("gen_single_sector_topology_interferers", (2, 3, 5, "uma-calibration")),
    ("random_ut_properties", (2, 5, 0.8, 0., 3.)),
    ("set_3gpp_scenario_parameters", ("rma", None, 1000.)),
])
def test_topology_helpers_bit_exact(name, args):
    _seed(11)
    want = getattr(JC, name)(*args)
    got = getattr(TC, name)(*args)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_relocate_uts_bit_exact():
    rng = np.random.default_rng(3)
    loc = rng.uniform(-50, 50, (2, 5, 2)).astype(np.float32)
    sectors = rng.integers(0, 3, (2, 5))
    cells = rng.uniform(-300, 300, (2, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(TC.relocate_uts(loc, sectors, cells),
                                  JC.relocate_uts(loc, sectors, cells))


# ----------------------------------------------------------------------
# Scenarios
# ----------------------------------------------------------------------
SCENARIOS = ["UMa", "UMi", "RMa"]
CASES = [(s, los, o2i) for s in SCENARIOS for los in (True, False, None)
         for o2i in ("low", "high") if not (s == "RMa" and o2i == "high")]


def _scenarios(name, los, o2i="low", direction="uplink", num_ut=6,
               outdoor=False):
    """The same scenario in both packages on the same drop (LoS requested
    or, with ``los=None``, drawn), as ``tests/test_tr38901_sys.py``
    makes it."""
    pair = []
    for pkg, ch in ((J, JC), (T, TC)):
        _seed(5)
        ut, bs = _arrays(pkg)
        cls = getattr(pkg, name + "Scenario")
        sc = cls(CARRIER, ut, bs, direction) if name == "RMa" \
            else cls(CARRIER, o2i, ut, bs, direction)
        topo = list(ch.gen_single_sector_topology(4, num_ut, name.lower()))
        if outdoor:
            topo[5] = np.zeros_like(topo[5])
        sc.set_topology(*topo, los=los)
        pair.append(sc)
    return pair


@pytest.mark.parametrize("name,los,o2i", CASES)
def test_scenario_state_matches_jax(name, los, o2i):
    """LoS and indoor states, distances, LoS angles, LoS probability,
    basic pathloss, LSP log-moments and ZOD offset: the same NumPy code
    on the same drop, bit for bit."""
    js, ts = _scenarios(name, los, o2i)
    for attr in ("indoor", "los", "distance_2d", "distance_3d",
                 "distance_2d_in", "distance_3d_out", "los_aoa", "los_zod",
                 "matrix_ut_distance_2d", "lsp_log_mean", "lsp_log_std",
                 "zod_offset", "basic_pathloss", "los_probability"):
        w, g = np.asarray(getattr(js, attr)), np.asarray(getattr(ts, attr))
        assert w.dtype == g.dtype, attr
        np.testing.assert_array_equal(g, w, err_msg=attr)
    for p in ("rTau", "zeta", "cDS", "muXPR", "numClusters"):
        np.testing.assert_array_equal(ts.get_param(p), js.get_param(p))
    # on the device: copies of the same arrays
    np.testing.assert_array_equal(ts.tensor("lsp_log_mean").numpy(),
                                  js.lsp_log_mean)
    np.testing.assert_array_equal(ts.param_tensor("cDS").numpy(),
                                  js.get_param("cDS"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_lsp_correlation_sqrt_and_lsps_given_jax_draws(name):
    js, ts = _scenarios(name, None)
    jg, tg = J.LSPGenerator(js), T.LSPGenerator(ts)
    jg.topology_updated_callback()
    tg.topology_updated_callback()
    np.testing.assert_array_equal(tg.cross_lsp_corr_sqrt,
                                  jg._cross_lsp_corr_sqrt)
    np.testing.assert_array_equal(tg.spatial_lsp_corr_sqrt,
                                  jg._spatial_lsp_corr_sqrt)
    key = jax.random.PRNGKey(4)
    jl = jg(key=key)
    normal = jax.random.normal(key, (4, 1, 6, 7), jnp.float32)
    tl = tg.lsp_from_normal(_t(normal))
    for f in ("ds", "asd", "asa", "sf", "k_factor", "zsa", "zsd"):
        w, g = np.asarray(getattr(jl, f)), getattr(tl, f).numpy()
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=LSP_RTOL, err_msg=f)


@pytest.mark.parametrize("name,o2i", [("UMa", "high"), ("UMi", "low"),
                                      ("RMa", "low")])
def test_pathloss_given_jax_draws(name, o2i):
    """Basic pathloss plus O2I loss, float64 in both packages."""
    js, ts = _scenarios(name, None, o2i)
    key = jax.random.PRNGKey(9)
    want = np.asarray(J.LSPGenerator(js).sample_pathloss(key=key))
    normal = jax.random.normal(key, (4, 1, 6), jnp.float32)
    got = T.LSPGenerator(ts).pathloss_from_normal(_t(normal)).numpy()
    assert want.dtype == got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _ray_draws(sc, key):
    """``RaysGenerator.__call__``'s draws under ``key`` (rays.py:60), as
    the port's ``rays_from_draws`` takes them."""
    keys = jax.random.split(key, 8)
    b, bs, ut = sc.batch_size, sc.num_bs, sc.num_ut
    cl, nr = sc.num_clusters_max, sc.rays_per_cluster
    shape, f32 = (b, bs, ut, cl), jnp.float32
    d = {"delay_u": jax.random.uniform(keys[0], shape, f32, 1e-6, 1.0),
         "power_z": jax.random.normal(keys[1], shape, f32),
         "xpr_z": jax.random.normal(keys[6], shape + (nr,), f32)}
    for i, name in enumerate(T.rays.ANGLES):
        k_sign, k_comp = jax.random.split(keys[2 + i])
        d[name + "_sign"] = 2. * jax.random.randint(
            k_sign, (b, bs, 1, cl), 0, 2).astype(f32) - 1.
        d[name + "_comp"] = jax.random.normal(k_comp, shape, f32)
    for name, k in zip(T.rays.ANGLES, jax.random.split(keys[7], 4)):
        d[name + "_perm"] = jnp.argsort(
            jax.random.normal(k, (b, bs, 1, cl, nr), f32), axis=-1)
    return {k: _t(v) for k, v in d.items()}


def _port_lsp(lsp):
    return T.LSP(*(_t(getattr(lsp, f)) for f in
                   ("ds", "asd", "asa", "sf", "k_factor", "zsa", "zsd")))


@pytest.mark.parametrize("name", SCENARIOS)
def test_rays_given_jax_draws(name):
    js, ts = _scenarios(name, None)
    jl, jr = J.LSPGenerator(js), J.RaysGenerator(js)
    tr = T.RaysGenerator(ts)
    jl.topology_updated_callback()
    jr.topology_updated_callback()
    tr.topology_updated_callback()
    lsp = jl(key=jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    want = jr(lsp, key=key)
    got = tr.rays_from_draws(_port_lsp(lsp), **_ray_draws(js, key))
    for f in ("delays", "powers", "aoa", "aod", "zoa", "zod", "xpr"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f
        np.testing.assert_array_less(np.abs(g - w),
                                     RAY_RTOL * np.abs(w).max() + 1e-30,
                                     err_msg=f)


# the three cases of tests/test_tr38901_sys.py:292
CHANNEL_CASES = [("UMi", "uplink"), ("UMa", "downlink"), ("RMa", "uplink")]


def _models(name, direction):
    pair = []
    for pkg, ch in ((J, JC), (T, TC)):
        _seed(7)
        ut, bs = _arrays(pkg)
        cls = getattr(pkg, name)
        model = cls(CARRIER, ut, bs, direction) if name == "RMa" \
            else cls(CARRIER, "low", ut, bs, direction)
        model.set_topology(*ch.gen_single_sector_topology(1, 3,
                                                          name.lower()))
        pair.append(model)
    return pair


@pytest.mark.parametrize("name,direction", CHANNEL_CASES)
def test_system_level_channel_matches_jax_given_its_draws(name, direction):
    """One site, 3 UTs, 2 time steps: the port's ``cir`` on JAX's frozen
    LSPs, ray draws, phases and O2I normals against JAX's channel."""
    jm, tm = _models(name, direction)
    jsc = jm._scenario
    np.testing.assert_array_equal(tm.scenario.los, jsc.los)
    key = jax.random.PRNGKey(7)
    a, tau = jax.jit(lambda k: jm(2, 30.72e6, key=k))(key)
    a, tau = np.asarray(a), np.asarray(tau)
    _, k_rays, k_cir, k_pl = jax.random.split(key, 4)
    lsp = _port_lsp(jm._lsp)
    rays = tm._ray_sampler.rays_from_draws(lsp, **_ray_draws(jsc, k_rays))
    b, bs, ut = jsc.batch_size, jsc.num_bs, jsc.num_ut
    links = (b, bs, ut) if direction == "downlink" else (b, ut, bs)
    phi = jax.random.uniform(k_cir, links + (jsc.num_clusters_max,
                                             jsc.rays_per_cluster, 4),
                             jnp.float32, -PI, PI)
    pl_normal = jax.random.normal(k_pl, (b, bs, ut), jnp.float32)
    ta, ttau = tm.cir(2, 30.72e6, lsp, rays, _t(phi), _t(pl_normal))
    assert ta.shape == a.shape and ta.dtype == torch.complex64
    assert ttau.shape == tau.shape and ttau.dtype == torch.float32
    np.testing.assert_array_less(np.abs(ttau.numpy() - tau),
                                 RAY_RTOL * np.abs(tau).max())
    np.testing.assert_array_less(np.abs(ta.numpy() - a),
                                 CIR_RTOL * np.abs(a).max())
    # the port's own draws: the same shapes, finite, tau >= 0
    a2, tau2 = tm(2, 30.72e6, generator=torch.Generator().manual_seed(0))
    assert a2.shape == a.shape and torch.isfinite(torch.view_as_real(a2)).all()
    assert (tau2 >= 0).all()


# ----------------------------------------------------------------------
# The port's own draws, by statistics
# ----------------------------------------------------------------------
def test_lsp_log_moments_of_own_draws():
    """log10(DS) of 200 draws against the scenario's mean and std, and
    the clipping of ASA and ZSA (tests/test_tr38901_sys.py:174)."""
    _, ts = _scenarios("UMa", True, outdoor=True)
    gen = T.LSPGenerator(ts)
    gen.topology_updated_callback()
    g = torch.Generator().manual_seed(0)
    lsps = [gen(generator=g) for _ in range(200)]
    logds = np.log10(np.stack([l.ds.numpy() for l in lsps]))
    np.testing.assert_allclose(logds.mean(0), ts.lsp_log_mean[..., 0],
                               atol=0.15)
    np.testing.assert_allclose(logds.std(0), ts.lsp_log_std[..., 0],
                               atol=0.12)
    assert all((l.asa <= 104.).all() and (l.zsa <= 52.).all() for l in lsps)


def test_lsp_spatial_correlation_of_own_draws():
    """Two UTs 0.1 m apart in the same state get nearly the same LSPs;
    one 134 m away does not (tests/test_tr38901_sys.py:194)."""
    _seed(0)
    sc = T.UMiScenario(CARRIER, "low", *_arrays(T), "uplink")
    zeros = np.zeros((1, 3, 3))
    bs_loc = np.array([[[0., 0., 10.]]])
    sc.set_topology(np.array([[[50., 0., 1.5], [50.1, 0., 1.5],
                               [-80., 30., 1.5]]]), bs_loc, zeros,
                    np.zeros((1, 1, 3)), zeros, np.zeros((1, 3), bool),
                    los=True)
    gen = T.LSPGenerator(sc)
    gen.topology_updated_callback()
    g = torch.Generator().manual_seed(1)
    logds = np.log10(np.stack([gen(generator=g).ds.numpy()[0, 0]
                               for _ in range(300)]))
    assert np.corrcoef(logds[:, 0], logds[:, 1])[0, 1] > 0.9
    assert np.corrcoef(logds[:, 0], logds[:, 2])[0, 1] < 0.35


def test_rays_properties_of_own_draws():
    """Sorted non-negative delays, unit total power with zero power on
    unused clusters, angles in range, positive XPR
    (tests/test_tr38901_sys.py:237)."""
    _, ts = _scenarios("UMi", None)
    lg, rg = T.LSPGenerator(ts), T.RaysGenerator(ts)
    lg.topology_updated_callback()
    rg.topology_updated_callback()
    g = torch.Generator().manual_seed(2)
    rays = rg(lg(generator=g), generator=g)
    delays, powers = rays.delays.numpy(), rays.powers.numpy()
    assert delays.shape == (4, 1, 6, ts.num_clusters_max)
    assert np.all(delays >= 0.) and np.all(np.diff(delays, axis=-1) >= 0.)
    np.testing.assert_allclose(powers.sum(-1), 1., atol=1e-6)
    assert np.all(powers[rg._cluster_mask == 1.] == 0.)
    assert (rays.zoa >= 0).all() and (rays.zoa <= PI + 1e-6).all()
    assert (rays.aoa.abs() <= PI + 1e-6).all() and (rays.xpr > 0).all()


def test_link_gain_of_own_draws_matches_jax_draws():
    """The links' gain of the port's own draws against the JAX package's
    own draws on one multi-cell drop (21 UMi sectors x 2 UTs, downlink,
    omni arrays, LSPs drawn anew each call): the gain of a link is
    10 log10 of the power summed over its paths; over 32 calls in each
    package, the means of its mean and standard deviation over the 882
    links agree within 5 standard errors of their difference. The mean
    varies by ~0.26 dB from call to call (LSPs correlated across UTs),
    so the band is about +-0.33 dB."""
    from sionna_tpu.sys import gen_hexgrid_topology as jax_hexgrid
    from sionna_tpu_torch.sys import gen_hexgrid_topology as torch_hexgrid
    reps = 32
    _seed(5)
    models = []
    for pkg, hexgrid in ((J, jax_hexgrid), (T, torch_hexgrid)):
        model = pkg.UMi(CARRIER, "low", *(pkg.PanelArray(
            1, 1, "single", "V", "omni", CARRIER),) * 2, "downlink",
            always_generate_lsp=True)
        model.set_topology(*hexgrid(1, num_rings=1, num_ut_per_sector=2,
                                    scenario="umi"))
        models.append(model)
    jm, tm = models
    np.testing.assert_array_equal(np.asarray(jm._scenario.los),
                                  tm.scenario.los)

    @jax.jit
    def jax_gain(key):
        a = jm(1, 30e3, key=key)[0]
        return 10 * jnp.log10(jnp.sum(jnp.abs(a) ** 2, axis=(2, 4, 5, 6)))

    g = torch.Generator().manual_seed(0)
    stats = {"jax": [], "torch": []}
    for r in range(reps):
        jg = np.asarray(jax_gain(jax.random.PRNGKey(r)))
        tg = (10 * torch.log10((tm(1, 30e3, generator=g)[0].abs() ** 2)
                               .sum(dim=(2, 4, 5, 6)))).numpy()
        stats["jax"].append((jg.mean(), jg.std()))
        stats["torch"].append((tg.mean(), tg.std()))
    jax_stats, torch_stats = (np.array(stats[k]) for k in ("jax", "torch"))
    se = np.sqrt((jax_stats.var(0, ddof=1) + torch_stats.var(0, ddof=1))
                 / reps)
    diff = np.abs(torch_stats.mean(0) - jax_stats.mean(0))
    assert np.all(diff <= 5 * se), (diff, se)


def test_channel_gain_includes_pathloss_and_generator_determinism():
    """Pathloss off raises the gain by orders of magnitude
    (tests/test_tr38901_sys.py:319); one seed gives one channel."""
    gains = {}
    for enable_pl in (True, False):
        _seed(3)
        model = T.UMi(CARRIER, "low", *_arrays(T), "uplink",
                      enable_pathloss=enable_pl, enable_shadow_fading=False)
        model.set_topology(*TC.gen_single_sector_topology(2, 3, "umi"))
        a, _ = model(4, 30.72e6, generator=torch.Generator().manual_seed(4))
        gains[enable_pl] = float((a.abs() ** 2).mean())
        a2, _ = model(4, 30.72e6, generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, a2)
    assert gains[False] / gains[True] > 1e4


def test_channel_blocks_take_config_device():
    """Without a ``device`` the scenario, and the draws and tables of
    the channel, follow ``config.device``."""
    device = torch_config.device
    try:
        torch_config.device = "meta"
        model = T.UMi(CARRIER, "low", *_arrays(T), "downlink")
        assert model.scenario.device == torch.device("meta")
        assert T.UMi(CARRIER, "low", *_arrays(T), "downlink",
                     device="cpu").scenario.device == torch.device("cpu")
    finally:
        torch_config.device = device
