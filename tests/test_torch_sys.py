"""The SYS package of the PyTorch port, and its NR and numerics
utilities, against the JAX package (BASELINE config 5).

- Bit-exact: the hexagonal grid and ``gen_hexgrid_topology`` from the
  same ``config.seed``, ``convert_hex_coord``; ``decode_mcs_index``,
  ``calculate_tb_size`` and their tensor forms over every MCS of every
  table; the PHY abstraction's tables and HARQ outcomes given JAX's
  uniforms; ILLA's and OLLA's MCS choices over a 20-slot trajectory; the
  PF scheduler's decisions; the config-5 slot loop (one UT per sector,
  10 slots) given JAX's fading and HARQ draws.
- To f32 rounding: the dB conversions, EESM, the BLER and TBLER, OLLA's
  offsets, both power controls, the three ``sys/utils.py`` functions,
  and the per-RE SINR of a single-sector version of ``chip_smoke.py``
  phase 21's chain fed JAX's UMi channel.

The port's tensor forms (MCS, TB size) are the JAX package's traced
forms, so the JAX side of those comparisons runs under ``jax.jit``.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.utils as JU
import sionna_tpu.sys as JS
from sionna_tpu.phy import config as jax_config
from sionna_tpu.phy.channel import (cir_to_ofdm_channel as j_cir_to_ofdm,
                                    gen_single_sector_topology,
                                    subcarrier_frequencies as j_freqs)
from sionna_tpu.phy.channel.tr38901 import PanelArray as JPanelArray, \
    UMi as JUMi
from sionna_tpu.phy.mimo import StreamManagement as JStreamManagement
from sionna_tpu.phy.nr import utils as JN
from sionna_tpu.phy.ofdm import (CBFPrecodedChannel as JCBF,
                                 LMMSEPostEqualizationSINR as JPostEq,
                                 ResourceGrid as JResourceGrid)
import sionna_tpu_torch.phy.utils as TU
import sionna_tpu_torch.sys as TS
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.nr import utils as TN
from sionna_tpu_torch.tools.sys_slots import (UMI_BS_POWER_DBM, DownlinkSlots,
                                              MulticellSlots,
                                              distance_proxy_sinr)

torch.set_num_threads(2)
# f32 transcendental functions of XLA and torch: a few ULP
F32_RTOL = 2.0 ** -20
# EESM: -beta log(mean(exp(-sinr / beta))), the mean summed in another
# order over up to 64 values: a few ULP of the log, relative to it
EESM_RTOL = 2.0 ** -18
# the per-RE SINR after CBF and LMMSE with whitening over 4 streams, in
# f32 (Cholesky, reciprocals and sums in another order): of the largest
SINR_RTOL = 2.0 ** -14


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    """The port's blocks default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


@pytest.fixture(scope="module")
def phy_abs():
    """(JAX, port) PHYAbstraction with the shipped tables."""
    return JS.PHYAbstraction(), TS.PHYAbstraction()


def _seed(s):
    jax_config.seed = s
    torch_config.seed = s


def _t(x):
    return torch.as_tensor(np.array(x))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------
# Utilities
# ----------------------------------------------------------------------
def test_db_conversions_and_misc_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(1e-6, 1e3, 64).astype(np.float32)
    db = rng.uniform(-60, 60, 64).astype(np.float32)
    for name, v in (("lin_to_db", x), ("db_to_lin", db),
                    ("watt_to_dbm", x), ("dbm_to_watt", db),
                    ("log10", x), ("log2", x)):
        w, g = np.asarray(getattr(JU, name)(v)), _n(getattr(TU, name)(_t(v)))
        assert w.dtype == g.dtype, name
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, err_msg=name)
    assert TU.to_list(np.arange(3.)) == JU.to_list(np.arange(3.))
    assert TU.to_list(4) == JU.to_list(4) and TU.to_list(None) is None
    nested = {"1": {"2": [3], "a": {"4": 5}}}
    assert TU.dict_keys_to_int(nested) == JU.dict_keys_to_int(nested)
    d = TU.DeepUpdateDict({"a": {"b": 1, "c": {"d": 2}}, "e": {"f": 1}})
    d.deep_update({"a": {"c": {"g": 3}}, "e": {"h": 2}}, stop_at_keys=("e",))
    assert d == {"a": {"b": 1, "c": {"d": 2, "g": 3}}, "e": {"h": 2}}
    s = TU.scalar_to_shaped_tensor(3, torch.int32, (2, 2), device="cpu")
    np.testing.assert_array_equal(
        s, JU.scalar_to_shaped_tensor(3, jnp.int32, (2, 2)))


def test_complex_normal_and_bernoulli_statistics():
    g = torch.Generator().manual_seed(0)
    z = TU.complex_normal((200000,), var=2.5, generator=g, device="cpu")
    assert z.dtype == torch.complex64
    assert abs(float((z.abs() ** 2).mean()) - 2.5) < 0.03
    assert abs(float(z.real.var()) - float(z.imag.var())) < 0.03
    b = TU.sample_bernoulli((200000,), 0.3, generator=g, device="cpu")
    assert b.dtype == torch.float32 and abs(float(b.mean()) - 0.3) < 0.005


def test_spline_griddata_interpolation_matches_jax():
    rng = np.random.default_rng(1)
    x, y = np.array([24., 500., 1000., 2000.]), np.linspace(-5, 5, 7)
    z = np.clip(rng.uniform(0, 1, (4, 7)) * (y < 2), 0, 1)
    xi, yi = np.arange(24, 2000, 100.), np.arange(-5, 5, 0.5)
    for method in ("struct", "unstruct"):
        jf = getattr(JU.SplineGriddataInterpolation(), method)
        tf = getattr(TU.SplineGriddataInterpolation(), method)
        if method == "struct":
            w, g = jf(z, x, y, xi, yi), tf(z, x, y, xi, yi)
        else:
            xs, ys = np.repeat(x, 7), np.tile(y, 4)
            w = jf(xs, ys, z.reshape(-1), xi, np.linspace(0, .9, 10))
            g = tf(xs, ys, z.reshape(-1), xi, np.linspace(0, .9, 10))
        np.testing.assert_array_equal(g, w)


def test_tensor_utilities_match_jax():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(3, 4, 5)).astype(np.float32)
    idx = np.stack([rng.integers(0, s, (6, 2)) for s in p.shape], -1)
    np.testing.assert_array_equal(
        TU.gather_from_batched_indices(_t(p), _t(idx)),
        JU.gather_from_batched_indices(p, idx))
    b = rng.uniform(size=(4, 7, 3)) < 0.3
    for side in ("first", "last"):
        for axis in (-1, 1):
            np.testing.assert_array_equal(
                TU.find_true_position(_t(b), side, axis),
                JU.find_true_position(b, side, axis))
    np.testing.assert_array_equal(TU.enumerate_indices([2, 3, 4]),
                                  JU.enumerate_indices([2, 3, 4]))
    np.testing.assert_array_equal(TU.flatten_dims(_t(p), 2, 1),
                                  JU.flatten_dims(p, 2, 1))
    np.testing.assert_array_equal(TU.split_dim(_t(p), (2, 2), 1),
                                  JU.split_dim(p, (2, 2), 1))
    assert bool(TU.tensor_values_are_in_set(_t([1, -1, 0]), [-1, 0, 1]))
    assert not bool(TU.tensor_values_are_in_set(_t([2, 0]), [-1, 0, 1]))


def _decreasing(x, c):
    return c - x ** 3


@pytest.mark.parametrize("regula_falsi", [False, True])
def test_bisection_and_expand_bound_match_jax(regula_falsi):
    c = np.array([0.5, 8., 30., 1e4], np.float32)
    for side, start in (("upper", 1.), ("lower", -1.)):
        w = JU.expand_bound(_decreasing, np.full(4, start, np.float32),
                            side=side, c=jnp.asarray(c))
        g = TU.expand_bound(_decreasing, _t(np.full(4, start, np.float32)),
                            side=side, c=_t(c))
        np.testing.assert_array_equal(g, w)
    w, fw = JU.bisection_method(_decreasing, np.zeros(4, np.float32),
                                np.ones(4, np.float32), c=jnp.asarray(c),
                                regula_falsi=regula_falsi)
    g, fg = TU.bisection_method(_decreasing, _t(np.zeros(4, np.float32)),
                                _t(np.ones(4, np.float32)), c=_t(c),
                                regula_falsi=regula_falsi)
    np.testing.assert_allclose(g, w, rtol=1e-5)
    if not regula_falsi:
        np.testing.assert_allclose(g.numpy() ** 3, c, rtol=1e-3)


# ----------------------------------------------------------------------
# NR utilities
# ----------------------------------------------------------------------
def test_decode_mcs_index_every_mcs_of_every_table_bit_exact():
    """Host and tensor forms against JAX's host and jitted forms, for
    PUSCH with and without transform precoding and PDSCH."""
    mcs = np.arange(29, dtype=np.int32)
    jit_form = jax.jit(JN.decode_mcs_index_jit, static_argnums=(2, 3))
    for table in (1, 2, 3, 4):
        for is_pusch, tp in ((True, True), (True, False), (False, False)):
            wm, wr = JN.decode_mcs_index(mcs, table, is_pusch, tp,
                                         check_index_validity=False)
            gm, gr = TN.decode_mcs_index(mcs, table, is_pusch, tp,
                                         check_index_validity=False)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gr, wr)
            jm, jr = jit_form(jnp.asarray(mcs), jnp.asarray(table),
                              is_pusch, tp)
            tm, tr = TN.decode_mcs_index_jit(_t(mcs), table, is_pusch, tp)
            assert tm.dtype == torch.int32 and tr.dtype == torch.float32
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(tr, jr)
    for bad in ((29, 1), (5, 5)):
        for pkg in (JN, TN):
            with pytest.raises(ValueError):
                pkg.decode_mcs_index(bad[0], bad[1])
    with pytest.raises(ValueError):
        TN.decode_mcs_index(28, 2, True, False)  # -1 entry, checked


def _tb_grid():
    """(modulation order, target rate, coded bits) of every valid MCS of
    every table, at allocations from 12 REs to 2 slots of 273 PRBs."""
    mods, rates = [], []
    for table in (1, 2, 3, 4):
        for is_pusch, tp in ((True, True), (False, False)):
            m, r = JN.decode_mcs_index(np.arange(29), table, is_pusch, tp,
                                       check_index_validity=False)
            ok = m > 0
            mods.append(m[ok])
            rates.append(r[ok])
    mods, rates = np.concatenate(mods), np.concatenate(rates)
    n_re = np.array([12, 100, 156, 480, 1000, 2016, 5000, 14 * 612,
                     30000, 2 * 12 * 14 * 273])
    m = np.repeat(mods, len(n_re))
    return m, np.repeat(rates, len(n_re)), m * np.tile(n_re, len(mods))


def test_calculate_tb_size_and_cb_size_jit_bit_exact():
    m, r, ncb = _tb_grid()
    want = JN.calculate_tb_size(m, r, num_coded_bits=ncb)
    got = TN.calculate_tb_size(m, r, num_coded_bits=ncb)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    jc, jn = jax.jit(JN.calculate_cb_size_jit)(
        jnp.asarray(m), jnp.asarray(r), jnp.asarray(ncb))
    tc, tn = TN.calculate_cb_size_jit(_t(m), _t(r), _t(ncb))
    assert tc.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(
        TN.calculate_num_coded_bits(4, 51, 14, 12, 2),
        JN.calculate_num_coded_bits(4, 51, 14, 12, 2))


def test_mcs_decoder_and_transport_block_take_the_traced_forms():
    mcs = np.array([[0, 5, 14], [20, 27, 28]], np.int32)
    for cat in (0, 1):
        jm, jr = jax.jit(lambda x: JN.MCSDecoderNR()(x, 1, cat))(
            jnp.asarray(mcs))
        tm, tr = TN.MCSDecoderNR(device="cpu")(_t(mcs), 1, cat)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tr, jr)
        jc, jn = jax.jit(lambda a, b, c: JN.TransportBlockNR()(a, b, c))(
            jm, jr, jm * 1000)
        tc, tn = TN.TransportBlockNR(device="cpu")(tm, tr, tm * 1000)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)
    # host input: the host forms, checked
    with pytest.raises(ValueError):
        TN.MCSDecoderNR(device="cpu")(28, 1, 0)
    np.testing.assert_array_equal(
        TN.TransportBlockNR(device="cpu")(4, 0.5, 4000),
        JN.TransportBlockNR()(4, 0.5, 4000))


# ----------------------------------------------------------------------
# Topology
# ----------------------------------------------------------------------
def test_hex_coordinates_and_grid_bit_exact():
    rng = np.random.default_rng(4)
    off = rng.integers(-5, 5, (10, 2))
    for conv in ("offset2axial", "offset2euclid"):
        w = JS.convert_hex_coord(off, conv, hex_radius=57.7)
        g = TS.convert_hex_coord(off, conv, hex_radius=57.7)
        np.testing.assert_array_equal(g, w)
        back = conv.replace("offset2", "") + "2offset"
        np.testing.assert_array_equal(
            TS.convert_hex_coord(g, back, hex_radius=57.7),
            JS.convert_hex_coord(w, back, hex_radius=57.7))
    assert TS.get_num_hex_in_grid(3) == JS.get_num_hex_in_grid(3) == 37
    for rings in (1, 2):
        jg = JS.HexGrid(rings, isd=200., cell_height=10.)
        tg = TS.HexGrid(rings, isd=200., cell_height=10.)
        np.testing.assert_array_equal(tg.cell_loc, jg.cell_loc)
        np.testing.assert_array_equal(tg.mirror_cell_loc, jg.mirror_cell_loc)
        _seed(rings)
        w = jg(2, 3, 10., min_ut_height=1.5, max_ut_height=8.)
        _seed(rings)
        g = tg(2, 3, 10., min_ut_height=1.5, max_ut_height=8.)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    h = TS.Hexagon(10., (2, -1))
    np.testing.assert_array_equal(h.neighbor(3).coord_dict()["axial"],
                                  JS.Hexagon(10., (2, -1)).neighbor(3)
                                  .coord_dict()["axial"])


@pytest.mark.parametrize("scenario,rings,upt", [("umi", 1, 4), ("uma", 1, 2),
                                                ("rma", 2, 1)])
def test_gen_hexgrid_topology_bit_exact(scenario, rings, upt):
    _seed(8)
    want = JS.gen_hexgrid_topology(2, rings, upt, scenario)
    _seed(8)
    got = TS.gen_hexgrid_topology(2, rings, upt, scenario)
    assert len(got) == len(want) == 8
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# EESM, PHY abstraction, link adaptation
# ----------------------------------------------------------------------
def _sinr_grid(rng, shape, zero_share=0.3):
    sinr = 10 ** (rng.uniform(-10, 30, shape) / 10)
    return (sinr * (rng.uniform(size=shape) > zero_share)).astype(np.float32)


@pytest.mark.parametrize("per_stream", [False, True])
def test_eesm_matches_jax(per_stream):
    rng = np.random.default_rng(5)
    sinr = _sinr_grid(rng, (2, 4, 8, 5, 2))
    sinr[0, ..., 3, :] = 0.      # a user with nothing scheduled
    sinr[1, ..., 4, :] = 1e-5    # below sinr_eff_min
    sinr[1, ..., 2, :] = 1e4     # exp(-sinr / beta) underflows
    mcs = rng.integers(0, 28, (2, 5)).astype(np.int32)
    table = rng.integers(1, 3, (2, 5)).astype(np.int32)  # beta: tables 1-2
    w = JS.EESM()(sinr, mcs, table, per_stream=per_stream)
    g = TS.EESM(device="cpu")(_t(sinr), _t(mcs), _t(table),
                              per_stream=per_stream)
    assert g.dtype == torch.float32 and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=EESM_RTOL, atol=1e-30)
    np.testing.assert_array_equal(TS.EESM(device="cpu").beta_tensor,
                                  JS.EESM().beta_tensor)


def test_phy_abstraction_tables_bler_and_harq_match_jax(phy_abs):
    jp, tp = phy_abs
    np.testing.assert_array_equal(tp.bler_table_interp, jp.bler_table_interp)
    np.testing.assert_array_equal(tp.snr_table_interp, jp.snr_table_interp)
    rng = np.random.default_rng(6)
    shape = (3, 40)
    mcs = rng.integers(0, 28, shape).astype(np.int32)
    sinr_eff = (10 ** (rng.uniform(-5, 25, shape) / 10)).astype(np.float32)
    n_re = rng.integers(0, 4000, shape).astype(np.int32)
    n_re[0, :5] = 0
    key = jax.random.PRNGKey(3)
    for cat in (0, 1):
        want = jax.jit(lambda m, s, n: jp(m, sinr_eff=s, num_allocated_re=n,
                                          mcs_category=cat, key=key))(
            jnp.asarray(mcs), jnp.asarray(sinr_eff), jnp.asarray(n_re))
        u = jax.random.uniform(key, shape, jnp.float32)
        got = tp(_t(mcs), sinr_eff=_t(sinr_eff), num_allocated_re=_t(n_re),
                 mcs_category=cat, uniform=_t(u))
        bits, harq, se, tbler, bler = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(got[0], bits)
        np.testing.assert_array_equal(got[1], harq)
        np.testing.assert_array_equal(got[2], se)
        ok = np.isfinite(tbler)
        np.testing.assert_array_equal(np.isfinite(got[3].numpy()), ok)
        np.testing.assert_allclose(got[3].numpy()[ok], tbler[ok],
                                   rtol=F32_RTOL, atol=1e-30)
        np.testing.assert_allclose(got[4].numpy()[ok], bler[ok],
                                   rtol=F32_RTOL, atol=1e-30)
    # from a per-RE SINR grid, through EESM
    sinr = _sinr_grid(rng, (2, 2, 6, 3, 1))
    mcs = rng.integers(0, 20, (2, 3)).astype(np.int32)
    want = jax.jit(lambda m, s: jp(m, sinr=s, key=key))(jnp.asarray(mcs),
                                                        jnp.asarray(sinr))
    got = tp(_t(mcs), sinr=_t(sinr),
             uniform=_t(jax.random.uniform(key, (2, 3), jnp.float32)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=EESM_RTOL)


def test_harq_statistics_of_own_draws(phy_abs):
    _, tp = phy_abs
    n = 100000
    mcs = torch.full((n,), 14, dtype=torch.int32)
    sinr = torch.full((n,), 10 ** 0.66, dtype=torch.float32)
    _, harq, _, tbler, _ = tp(mcs, sinr_eff=sinr,
                              num_allocated_re=torch.full((n,), 500),
                              generator=torch.Generator().manual_seed(0))
    p = float(tbler[0])
    assert 0.05 < p < 0.95
    nack = float((harq == 0).float().mean())
    assert abs(nack - p) < 5 * (p * (1 - p) / n) ** 0.5


def test_illa_matches_jax(phy_abs):
    jp, tp = phy_abs
    rng = np.random.default_rng(7)
    sinr_eff = (10 ** (rng.uniform(-8, 30, (4, 30)) / 10)).astype(np.float32)
    n_re = rng.integers(0, 3000, (4, 30)).astype(np.int32)
    for table, cat in ((1, 0), (2, 1), (3, 1)):
        j_illa = JS.InnerLoopLinkAdaptation(jp, bler_target=0.1)
        want = jax.jit(lambda s, n: j_illa(
            sinr_eff=s, num_allocated_re=n, mcs_table_index=table,
            mcs_category=cat, return_lowest_available_mcs=True))(
            jnp.asarray(sinr_eff), jnp.asarray(n_re))
        got = TS.InnerLoopLinkAdaptation(tp, bler_target=0.1)(
            sinr_eff=_t(sinr_eff), num_allocated_re=_t(n_re),
            mcs_table_index=table, mcs_category=cat,
            return_lowest_available_mcs=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    sinr = _sinr_grid(rng, (3, 2, 4, 5, 1))
    want = jax.jit(lambda s: JS.InnerLoopLinkAdaptation(jp)(sinr=s))(
        jnp.asarray(sinr))
    np.testing.assert_array_equal(
        TS.InnerLoopLinkAdaptation(tp)(sinr=_t(sinr)), want)


def test_olla_20_slot_trajectory_bit_exact(phy_abs):
    """The functional step (jitted in JAX) and the eager call, given the
    same SINRs and HARQ: MCS each slot, offsets and last SINR."""
    jp, tp = phy_abs
    rng = np.random.default_rng(8)
    num_ut = 12
    jo = JS.OuterLoopLinkAdaptation(jp, num_ut, batch_size=2)
    to = TS.OuterLoopLinkAdaptation(tp, num_ut, batch_size=2)
    je = JS.OuterLoopLinkAdaptation(jp, num_ut, batch_size=2, delta_up=0.5)
    te = TS.OuterLoopLinkAdaptation(tp, num_ut, batch_size=2, delta_up=0.5)
    jstep = jax.jit(lambda st, n, h, s: jo.step(st, n, harq_feedback=h,
                                                sinr_eff=s))
    js, ts = jo.init_state(), to.init_state()
    harq = np.full((2, num_ut), -1, np.int32)
    for slot in range(20):
        s = (10 ** (rng.uniform(-5, 25, (2, num_ut)) / 10)).astype(
            np.float32)
        s[:, 0] = 0.  # no new SINR observed
        n_re = rng.integers(0, 2000, (2, num_ut)).astype(np.int32)
        js, jm = jstep(js, jnp.asarray(n_re), jnp.asarray(harq),
                       jnp.asarray(s))
        ts, tm = to.step(ts, _t(n_re), harq_feedback=_t(harq),
                         sinr_eff=_t(s))
        np.testing.assert_array_equal(tm, jm, err_msg=f"slot {slot}")
        np.testing.assert_array_equal(ts[0], js[0])
        # 10 log10 of the SINR (XLA's and torch's log10)
        np.testing.assert_allclose(ts[1], js[1], rtol=F32_RTOL)
        np.testing.assert_array_equal(te(_t(n_re), _t(harq), _t(s)),
                                      je(n_re, harq, s))
        np.testing.assert_array_equal(te.offset, je.offset)
        harq = rng.integers(-1, 2, (2, num_ut)).astype(np.int32)
    with pytest.raises(ValueError):
        te(_t(n_re), _t(np.full((2, num_ut), 2)), _t(s))


def test_pf_scheduler_decisions_bit_exact():
    rng = np.random.default_rng(9)
    shape = (2, 3, 5, 7)
    js = JS.PFSchedulerSUMIMO(7, 5, 3, batch_size=2, num_streams_per_ut=2)
    ts = TS.PFSchedulerSUMIMO(7, 5, 3, batch_size=2, num_streams_per_ut=2,
                              device="cpu")
    for _ in range(6):
        last = rng.uniform(0, 5, (2, 7)).astype(np.float32)
        ach = rng.uniform(0, 8, shape).astype(np.float32)
        w = np.asarray(js(last, ach))
        g = ts(_t(last), _t(ach))
        assert g.dtype == torch.bool and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ts.rate_achieved_past,
                                      js.rate_achieved_past)
        np.testing.assert_array_equal(ts.pf_metric, js.pf_metric)


# ----------------------------------------------------------------------
# Power control and SYS utilities
# ----------------------------------------------------------------------
def test_open_loop_uplink_power_control_matches_jax():
    rng = np.random.default_rng(10)
    pl = (10 ** (rng.uniform(60, 140, (3, 6)) / 10)).astype(np.float32)
    n_sc = rng.integers(0, 600, (3, 6)).astype(np.float32)
    w = JS.open_loop_uplink_power_control(pl, n_sc, alpha=0.8, p0_dbm=-80.)
    g = TS.open_loop_uplink_power_control(_t(pl), _t(n_sc), alpha=0.8,
                                          p0_dbm=-80.)
    np.testing.assert_allclose(g, w, rtol=4 * F32_RTOL)


@pytest.mark.parametrize("fairness", [0., 0.5, 2.])
def test_downlink_fair_power_control_matches_jax(fairness):
    rng = np.random.default_rng(11)
    pl = (10 ** (rng.uniform(70, 120, (2, 5)) / 10)).astype(np.float32)
    ipn = (10 ** (rng.uniform(-130, -110, (2, 5)) / 10)).astype(np.float32)
    n_re = rng.integers(0, 400, (2, 5)).astype(np.float32)
    n_re[1, 2] = 0
    w = JS.downlink_fair_power_control(pl, ipn, n_re, fairness=fairness,
                                       return_lagrangian=True)
    g = TS.downlink_fair_power_control(_t(pl), _t(ipn), _t(n_re),
                                       fairness=fairness,
                                       return_lagrangian=True)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert float(g[0][1, 2]) == 0.
    # the budget of 56 dBm per BS is used up
    np.testing.assert_allclose(g[0].sum(-1), 10 ** 2.6, rtol=1e-3)


def test_sys_utils_match_jax():
    rng = np.random.default_rng(12)
    sinr = _sinr_grid(rng, (2, 3, 4, 5, 2), zero_share=0.8)
    sinr[..., 1, :] = 0.
    np.testing.assert_array_equal(TS.is_scheduled_in_slot(sinr=_t(sinr)),
                                  JS.is_scheduled_in_slot(sinr=sinr))
    h = (rng.normal(size=(2, 4, 2, 3, 2, 5, 6))
         + 1j * rng.normal(size=(2, 4, 2, 3, 2, 5, 6))).astype(np.complex64)
    assoc = np.zeros((4, 3), int)
    assoc[[0, 1, 2, 3], [2, 0, 1, 0]] = 1
    w = JS.get_pathloss(h, rx_tx_association=assoc)
    g = TS.get_pathloss(_t(h), rx_tx_association=assoc)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=F32_RTOL)
    is_sched = rng.uniform(size=(2, 3, 8, 4, 2)) < 0.4
    p_ut = rng.uniform(0, 5, (2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TS.spread_across_subcarriers(_t(p_ut), _t(is_sched)),
        JS.spread_across_subcarriers(p_ut, is_sched), rtol=F32_RTOL)


def test_new_bler_table_point_through_the_plain_decoder():
    """One Monte-Carlo BLER point through ``CodedAWGNChannelNR`` (the
    case of tests/test_sys.py:120): at 20 dB MCS 5 decodes. (A block of
    its own: the new table replaces that MCS's entry.)"""
    tp = TS.PHYAbstraction()
    torch_config.seed = 3
    new_table = tp.new_bler_table(
        [20.], [200], {"category": {0: {"index": {1: {"MCS": [5]}}}}},
        batch_size=64, max_mc_iter=2, verbose=False)
    bler = new_table["category"][0]["index"][1]["MCS"][5]["CBS"][200][
        "BLER"]
    assert len(bler) == 1 and bler[0] < 0.1
    assert tp.bler_table["category"][0]["index"][1]["MCS"][5]["CBS"][200][
        "BLER"] == bler


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------
def test_config5_slot_loop_matches_jax_given_its_draws():
    """``bench.bench_sys``'s loop at one UT per sector (21 UTs), 10
    slots: the same drop, and given JAX's fading and HARQ draws the
    same MCS, HARQ and decoded bits in every slot."""
    _seed(0)
    tm = MulticellSlots(num_ut_per_sector=1, device="cpu")
    _seed(0)
    topo = JS.gen_hexgrid_topology(1, 1, 1, "umi")
    for a, b in zip(tm.topology, topo):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    num_ut = tm.num_ut
    jp = JS.PHYAbstraction()
    jo = JS.OuterLoopLinkAdaptation(jp, num_ut, bler_target=0.1)
    base = jnp.asarray(distance_proxy_sinr(*topo[:2]), jnp.float32)
    n_re = jnp.full((num_ut,), 1000, jnp.int32)

    @jax.jit
    def jslot(state, harq, key):
        k1, k2 = jax.random.split(key)
        fading = jax.random.exponential(k1, (num_ut,), jnp.float32)
        sinr_eff = base * fading
        state, mcs = jo.step(state, n_re, harq_feedback=harq,
                             sinr_eff=sinr_eff)
        bits, harq, *_ = jp(mcs, sinr_eff=sinr_eff, num_allocated_re=n_re,
                            key=k2)
        u = jax.random.uniform(k2, (num_ut,), jnp.float32)
        return state, harq, bits, mcs, fading, u

    js, ts = jo.init_state(), tm.olla.init_state()
    jh = jnp.full((num_ut,), -1, jnp.int32)
    th = torch.full((num_ut,), -1, dtype=torch.int32)
    for s in range(10):
        key = jax.random.fold_in(jax.random.PRNGKey(0), s)
        js, jh, jb, jm, fading, u = jslot(js, jh, key)
        ts, th, tb, tmcs = tm.slot(ts, th, _t(fading), uniform=_t(u))
        np.testing.assert_array_equal(tmcs, jm, err_msg=f"slot {s}")
        np.testing.assert_array_equal(th, jh, err_msg=f"slot {s}")
        np.testing.assert_array_equal(tb, jb, err_msg=f"slot {s}")


def _omni(pkg_array):
    return pkg_array(num_rows_per_panel=1, num_cols_per_panel=1,
                     polarization="single", polarization_type="V",
                     antenna_pattern="omni", carrier_frequency=3.5e9)


def test_single_sector_downlink_chain_matches_jax_on_its_channel():
    """``chip_smoke.py`` phase 21's chain for one sector of 4 UTs, 14
    symbols x 24 subcarriers, 3 slots on JAX's UMi channel: the
    schedule, the MCS, the HARQ and bits given JAX's uniforms are the
    same; the per-RE SINR and effective SINR agree to rounding."""
    num_ut, num_sc, num_sym = 4, 24, 14
    _seed(21)
    topo = gen_single_sector_topology(1, num_ut, "umi")
    model = JUMi(3.5e9, "low", _omni(JPanelArray), _omni(JPanelArray),
                 "downlink")
    model.set_topology(*topo)
    port = DownlinkSlots(num_ut_per_sector=num_ut, num_subcarriers=num_sc,
                         topology=topo, device="cpu")
    sample = jax.jit(lambda k: j_cir_to_ofdm(
        j_freqs(num_sc, 30e3), *model(num_sym, 30e3, key=k)))

    # the same chain of the JAX package's blocks
    rg = JResourceGrid(num_sym, num_sc, 30e3, num_tx=1,
                       num_streams_per_tx=num_ut)
    assoc = np.ones((num_ut, 1), np.int64)
    sm = JStreamManagement(assoc, num_ut)
    cbf, posteq = JCBF(rg, sm), JPostEq(rg, sm)
    sched = JS.PFSchedulerSUMIMO(num_ut, num_sc, num_sym, batch_size=[1, 1])
    jp = JS.PHYAbstraction()
    olla = JS.OuterLoopLinkAdaptation(jp, num_ut, batch_size=1)
    eesm = JS.EESM()
    no, p_re = port.no, port.p_re

    def front(h):
        pl_all, pl_serv = JS.get_pathloss(h, assoc)
        h2_serv = jnp.abs(h[:, :, 0, 0:1, 0]) ** 2
        ipn = no + p_re * (jnp.sum(1. / pl_all, axis=2) - 1. / pl_serv)
        rate = jnp.log2(1. + h2_serv[:, :, 0] * p_re / ipn[..., None])
        return pl_serv, ipn, rate.reshape(1, 1, num_ut, num_sym, num_sc
                                          ).transpose(0, 1, 3, 4, 2)

    def back(h, is_sched, pl_serv, ipn, state, harq, se_last, key):
        n_sc = jnp.sum(is_sched[..., 0], axis=-2)
        pw, _ = JS.downlink_fair_power_control(
            pl_serv.reshape(1, 1, num_ut, num_sym).transpose(0, 1, 3, 2),
            ipn.reshape(1, 1, num_ut, num_sym).transpose(0, 1, 3, 2), n_sc,
            bs_max_power_dbm=UMI_BS_POWER_DBM)
        pw = JS.spread_across_subcarriers(pw, is_sched, num_tx=1).reshape(
            1, 1, num_ut, num_sym, num_sc)
        sinr = posteq(cbf(h, pw), no)
        n_re = jnp.sum(is_sched, axis=(2, 3, 5)).reshape(1, num_ut)
        state, mcs = olla.step(state, n_re, harq_feedback=harq,
                               sinr_eff=se_last, mcs_table_index=1,
                               mcs_category=1)
        se = eesm(sinr, mcs, 1)
        bits, harq, *_ = jp(mcs, sinr_eff=se, num_allocated_re=n_re,
                            mcs_table_index=1, mcs_category=1, key=key)
        return sinr, state, mcs, se, bits, harq

    back = jax.jit(back)
    state, harq = olla.init_state(), jnp.full((1, num_ut), -1, jnp.int32)
    se_last = jnp.zeros((1, num_ut), jnp.float32)
    rate_last = np.zeros((1, 1, num_ut), np.float32)
    t_state = port.init_state()
    for s in range(3):
        h = sample(jax.random.PRNGKey(100 + s))
        pl_serv, ipn, rate = front(h)
        is_sched = sched(rate_last, rate)
        key = jax.random.PRNGKey(200 + s)
        sinr, state, mcs, se, bits, harq = back(
            h, jnp.asarray(is_sched), pl_serv, ipn, state, harq, se_last,
            key)
        se_last = se
        rate_last = np.asarray(bits, np.float32).reshape(1, 1, num_ut) / (
            num_sym * num_sc)
        u = jax.random.uniform(key, (1, num_ut), jnp.float32)
        t_state, out = port.slot(t_state, h=_t(h), uniform=_t(u))
        np.testing.assert_array_equal(out["is_scheduled"].numpy(),
                                      np.asarray(is_sched))
        sinr = np.asarray(sinr)
        np.testing.assert_array_less(np.abs(out["sinr"].numpy() - sinr),
                                     SINR_RTOL * sinr.max())
        np.testing.assert_allclose(out["sinr_eff"], se, rtol=SINR_RTOL)
        np.testing.assert_array_equal(out["mcs"], mcs)
        np.testing.assert_array_equal(out["harq"], harq)
        np.testing.assert_array_equal(out["bits"], bits)
        assert int(np.sum(bits)) >= 0 and np.all(np.isfinite(sinr))


def test_sys_blocks_take_config_device():
    """Built without a ``device`` the SYS blocks' tables and state land
    on ``config.device`` (as tests/test_torch_core.py checks for the PHY
    blocks); an explicit ``device`` wins."""
    device = torch_config.device
    try:
        torch_config.device = "meta"
        pa = TS.PHYAbstraction()
        assert pa.device.type == pa.bler_table_interp.device.type == "meta"
        assert TS.EESM().beta_tensor.device.type == "meta"
        olla = TS.OuterLoopLinkAdaptation(pa, 4)
        assert olla.offset.device.type == "meta"
        assert olla.init_state()[1].device.type == "meta"
        sched = TS.PFSchedulerSUMIMO(4, 2, 3)
        assert sched.rate_achieved_past.device.type == "meta"
        assert TS.EESM(device="cpu").beta_tensor.device.type == "cpu"
        assert TN.CodedAWGNChannelNR().device.type == "meta"
    finally:
        torch_config.device = device
