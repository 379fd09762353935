"""OFDM blocks of the PyTorch port against the JAX package on the same
inputs: the row-column interleaver, the Kronecker pilots, resource-grid
mapping and demapping, nulled-subcarrier removal and nearest-neighbour
interpolation bit-exact; LS estimation with linear interpolation, the
LMMSE, ZF and MF equalizers and the post-equalization SINR to f32
rounding; the LMMSE interpolators (1D, spatial, ordered) to the rounding
of their precision."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.phy.fec.interleaving as jil
import sionna_tpu.phy.mimo as jmimo
import sionna_tpu.phy.ofdm as jofdm
import sionna_tpu.phy.utils as jutils
from sionna_tpu_torch.phy.fec.interleaving import (Deinterleaver,
                                                   RowColumnInterleaver)
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.ofdm import (LinearInterpolator,
                                       LMMSEEqualizer, LMMSEInterpolator,
                                       LMMSEInterpolator1D,
                                       LMMSEPostEqualizationSINR,
                                       LSChannelEstimator, MFEqualizer,
                                       NearestNeighborInterpolator,
                                       PostEqualizationSINR,
                                       RemoveNulledSubcarriers, ResourceGrid,
                                       ResourceGridDemapper,
                                       ResourceGridMapper,
                                       SpatialChannelFilter, ZFEqualizer,
                                       tdl_freq_cov_mat, tdl_time_cov_mat)
from sionna_tpu_torch.phy.utils import ebnodb2no, load_numpy_state
from sionna_tpu_torch.phy.utils.linalg import (_matmul, cholesky_solve,
                                               inv_cholesky, matrix_pinv)
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

# LS estimates divide by unit-modulus pilots: complex division rounds
# differently in XLA and torch, a few ULP of |h| <= ~5.
LS_ATOL = 1e-5
# LMMSE: JAX takes its plane path (whitening and solves on planes), the
# port the generic per-RE algebra; the same f32 operations in another
# order agree to a few ULP of the condition-scaled result (measured
# < 2e-6 on these inputs).
LMMSE_RTOL, LMMSE_ATOL = 1e-4, 1e-5

# (grid kwargs, rx_tx_association, num_streams_per_tx, num_rx_ant):
# the flagship's SISO grid, cut to 64 subcarriers, and a 2x2-stream grid
# with guard carriers and a DC null whose receivers see an interferer
GRIDS = {
    "flagship": (dict(num_ofdm_symbols=14, fft_size=64,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=1, cyclic_prefix_length=16,
                      pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11]),
                 [[1]], 1, 1),
    "guard_dc": (dict(num_ofdm_symbols=14, fft_size=76,
                      subcarrier_spacing=15e3, num_tx=2,
                      num_streams_per_tx=2, cyclic_prefix_length=6,
                      num_guard_carriers=(5, 6), dc_null=True,
                      pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11]),
                 [[1, 0], [0, 1]], 2, 4),
}


def _grids(name):
    kw = GRIDS[name][0]
    return jofdm.ResourceGrid(**kw), ResourceGrid(**kw)


def _cplx(rng, shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("n,depth,shape", [(3072, 4, (3, 1, 1)),
                                           (1003, 4, (2,)), (60, 7, (2, 3))])
def test_row_column_interleaver_bit_exact(n, depth, shape):
    x = np.random.default_rng(n).normal(size=shape + (n,)).astype(np.float32)
    ji, ti = jil.RowColumnInterleaver(row_depth=depth), \
        RowColumnInterleaver(row_depth=depth)
    got = ti(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ji(jnp.asarray(x))))
    np.testing.assert_array_equal(ti.perm_seq, ji._perms(n)[0])
    back = Deinterleaver(ti)(got)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jil.Deinterleaver(ji)(ji(jnp.asarray(x)))))
    with pytest.raises(TypeError):
        Deinterleaver(object())


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_resource_grid_and_pilots_match_jax(name):
    jrg, trg = _grids(name)
    for attr in ("num_data_symbols", "num_pilot_symbols",
                 "num_effective_subcarriers", "num_zero_symbols", "dc_ind",
                 "ofdm_symbol_duration", "bandwidth", "num_time_samples"):
        assert getattr(trg, attr) == getattr(jrg, attr), attr
    np.testing.assert_array_equal(trg.effective_subcarrier_ind,
                                  jrg.effective_subcarrier_ind)
    np.testing.assert_array_equal(trg.build_type_grid(),
                                  jrg.build_type_grid())
    # the Kronecker pilots exported from JAX check equal (bit-exact)
    exported = {"mask": jrg.pilot_pattern.mask,
                "pilots": jrg.pilot_pattern.pilots}
    load_numpy_state(trg.pilot_pattern, exported)
    mapper = ResourceGridMapper(trg)
    load_numpy_state(mapper, {f"pilot_pattern.{k}": v
                              for k, v in exported.items()})
    bad = exported["pilots"].copy()
    bad[0, 0, 0] *= -1
    with pytest.raises(ValueError, match="pilots"):
        load_numpy_state(trg.pilot_pattern, {"pilots": bad})
    # ebnodb2no with the grid's overheads
    for ebno_db in (0.0, 5.0, 8.0):
        want = np.asarray(jutils.ebnodb2no(jnp.float32(ebno_db), 4, 0.5, jrg))
        got = ebnodb2no(ebno_db, 4, 0.5, resource_grid=trg)
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_mapping_and_nulled_removal_bit_exact(name):
    jrg, trg = _grids(name)
    rng = np.random.default_rng(1)
    x = _cplx(rng, (3, trg.num_tx, trg.num_streams_per_tx,
                    trg.num_data_symbols))
    grid = ResourceGridMapper(trg)(torch.as_tensor(x))
    want = np.asarray(jax.jit(jofdm.ResourceGridMapper(jrg))(jnp.asarray(x)))
    assert grid.shape == want.shape
    np.testing.assert_array_equal(grid.numpy(), want)
    y = _cplx(rng, (3, 2, 2, 14, trg.fft_size))
    np.testing.assert_array_equal(
        RemoveNulledSubcarriers(trg)(torch.as_tensor(y)).numpy(),
        np.asarray(jofdm.RemoveNulledSubcarriers(jrg)(jnp.asarray(y))))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_nn_interpolator_bit_exact(name):
    jrg, trg = _grids(name)
    rng = np.random.default_rng(2)
    n_p = trg.num_pilot_symbols
    h = _cplx(rng, (2, 1, 2, trg.num_tx, trg.num_streams_per_tx, n_p))
    ev = rng.random((trg.num_tx, trg.num_streams_per_tx, n_p)).astype(
        np.float32)
    th, tev = NearestNeighborInterpolator(trg.pilot_pattern)(
        torch.as_tensor(h), torch.as_tensor(ev))
    jh, jev = jofdm.NearestNeighborInterpolator(jrg.pilot_pattern)(
        jnp.asarray(h), jnp.asarray(ev))
    assert th.shape == jh.shape and tev.shape == jev.shape
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_ls_estimator_matches_jax(name):
    jrg, trg = _grids(name)
    rng = np.random.default_rng(3)
    y = _cplx(rng, (2, 2, 2, 14, trg.fft_size))
    no = np.float32(0.1)
    th, tev = LSChannelEstimator(trg)(torch.as_tensor(y), torch.tensor(no))
    jh, jev = jax.jit(jofdm.LSChannelEstimator(jrg))(jnp.asarray(y), no)
    assert th.shape == jh.shape and tev.shape == jev.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=LS_ATOL)
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    # linear interpolation: a dense [RE, pilots] operator (at most four
    # nonzero weights per RE) applied by a complex matrix product; its
    # sums round differently from XLA's einsum by a few ULP of |h|
    for interp in ("lin", "lin_time_avg"):
        th, tev = LSChannelEstimator(trg, interpolation_type=interp)(
            torch.as_tensor(y), torch.tensor(no))
        jh, jev = jax.jit(jofdm.LSChannelEstimator(
            jrg, interpolation_type=interp))(jnp.asarray(y), no)
        assert th.shape == jh.shape and tev.shape == jev.shape
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=LS_ATOL)
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-6,
                                   atol=1e-7)
        # the batch-less err_var reaches a linear interpolator given as
        # ``interpolator=`` too, with the same result
        est = LSChannelEstimator(trg, interpolator=LinearInterpolator(
            trg.pilot_pattern, time_avg=interp == "lin_time_avg"))
        th2, tev2 = est(torch.as_tensor(y), torch.tensor(no))
        assert torch.equal(th2, th) and torch.equal(tev2, tev)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_lmmse_equalizer_matches_jax(name):
    _, assoc, n_s, n_rxa = GRIDS[name]
    jrg, trg = _grids(name)
    jsm = jmimo.StreamManagement(np.array(assoc), n_s)
    tsm = StreamManagement(np.array(assoc), n_s)
    for attr in ("detection_desired_ind", "detection_undesired_ind",
                 "stream_ind", "rx_stream_ids", "stream_association"):
        np.testing.assert_array_equal(getattr(tsm, attr), getattr(jsm, attr))
    rng = np.random.default_rng(4)
    b, n_rx, n_tx = 2, len(assoc), len(assoc[0])
    n_eff = trg.num_effective_subcarriers
    y = _cplx(rng, (b, n_rx, n_rxa, 14, trg.fft_size))
    h = _cplx(rng, (b, n_rx, n_rxa, n_tx, n_s, 14, n_eff), np.sqrt(0.5))
    ev = (0.01 * rng.random((n_tx, n_s, 14, n_eff))).astype(np.float32)
    no = (0.05 + 0.1 * rng.random(b)).astype(np.float32)
    tx, tno = LMMSEEqualizer(trg, tsm)(*(torch.as_tensor(a)
                                         for a in (y, h, ev, no)))
    jx, jno = jax.jit(jofdm.LMMSEEqualizer(jrg, jsm))(y, h, ev, no)
    assert tx.shape == jx.shape == (b, n_tx, n_s, trg.num_data_symbols)
    assert tno.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=LMMSE_RTOL,
                               atol=LMMSE_ATOL)
    np.testing.assert_allclose(tno.numpy(), np.asarray(jno),
                               rtol=LMMSE_RTOL, atol=LMMSE_ATOL)


@pytest.mark.parametrize("m", [1, 3, 6])
def test_cholesky_helpers(m):
    """The unrolled (m <= 4) and library (m > 4) paths solve A x = b and
    invert the Cholesky factor; f32 to a few ULP of the result."""
    rng = np.random.default_rng(m)
    g = _cplx(rng, (5, m, m))
    a = g @ np.conj(np.swapaxes(g, -1, -2)) + m * np.eye(m, dtype=np.complex64)
    rhs = _cplx(rng, (5, m, 2))
    ta = torch.as_tensor(a)
    l_inv = inv_cholesky(ta).numpy()
    l = np.linalg.cholesky(a.astype(np.complex128))
    np.testing.assert_allclose(l_inv, np.linalg.inv(l), rtol=0, atol=1e-5)
    x = cholesky_solve(torch.linalg.cholesky(ta), torch.as_tensor(rhs))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, rhs), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 4, 5])
def test_small_matmul_matches_torch_matmul(k):
    """The product unrolled over the inner dimension (k <= 4; k = 5 takes
    torch.matmul) against torch.matmul, batch dims broadcast as the
    equalizer broadcasts them: bit-exact for k = 1, f32 rounding of the
    sums above."""
    rng = np.random.default_rng(k)
    a = torch.as_tensor(_cplx(rng, (3, 1, 4, 2, k)))
    b = torch.as_tensor(_cplx(rng, (5, 1, k, 3)))
    got, want = _matmul(a, b), torch.matmul(a, b)
    assert got.shape == want.shape == (3, 5, 4, 2, 3)
    if k == 1:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


# ZF/MF: the Gram matrix, its Cholesky inverse and the products in
# another order than XLA's, f32; relative to the largest |x_hat| and
# no_eff (ZF's no_eff grows with the Gram matrix's condition number on
# these random channels).
EQ_RTOL = 1e-4


@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("kind", ["ZF", "MF"])
def test_zf_mf_equalizers_match_jax(name, kind):
    _, assoc, n_s, n_rxa = GRIDS[name]
    jrg, trg = _grids(name)
    jsm = jmimo.StreamManagement(np.array(assoc), n_s)
    tsm = StreamManagement(np.array(assoc), n_s)
    rng = np.random.default_rng(6)
    b, n_rx, n_tx = 2, len(assoc), len(assoc[0])
    n_eff = trg.num_effective_subcarriers
    y = _cplx(rng, (b, n_rx, n_rxa, 14, trg.fft_size))
    h = _cplx(rng, (b, n_rx, n_rxa, n_tx, n_s, 14, n_eff), np.sqrt(0.5))
    ev = (0.01 * rng.random((n_tx, n_s, 14, n_eff))).astype(np.float32)
    no = (0.05 + 0.1 * rng.random(b)).astype(np.float32)
    tcls = {"ZF": ZFEqualizer, "MF": MFEqualizer}[kind]
    jcls = {"ZF": jofdm.ZFEqualizer, "MF": jofdm.MFEqualizer}[kind]
    tx, tno = tcls(trg, tsm)(*(torch.as_tensor(a) for a in (y, h, ev, no)))
    jx, jno = jax.jit(jcls(jrg, jsm))(y, h, ev, no)
    jx, jno = np.asarray(jx), np.asarray(jno)
    assert tx.shape == jx.shape == (b, n_tx, n_s, trg.num_data_symbols)
    assert tno.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0,
                               atol=EQ_RTOL * np.abs(jx).max())
    np.testing.assert_allclose(tno.numpy(), jno, rtol=0,
                               atol=EQ_RTOL * np.abs(jno).max())


def test_matrix_pinv():
    """(A^H A)^{-1} A^H of full-column-rank matrices: a left inverse,
    and JAX's to f32 rounding."""
    rng = np.random.default_rng(7)
    for m, k in ((1, 1), (4, 2), (7, 5)):
        a = _cplx(rng, (3, m, k))
        got = matrix_pinv(torch.as_tensor(a)).numpy()
        want = np.asarray(jutils.matrix_pinv(jnp.asarray(a)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got @ a, np.broadcast_to(
            np.eye(k), (3, k, k)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_post_equalization_sinr_matches_jax(name):
    _, assoc, n_s, n_rxa = GRIDS[name]
    jrg, trg = _grids(name)
    jsm = jmimo.StreamManagement(np.array(assoc), n_s)
    tsm = StreamManagement(np.array(assoc), n_s)
    rng = np.random.default_rng(8)
    b, n_rx, n_tx = 2, len(assoc), len(assoc[0])
    n_eff = trg.num_effective_subcarriers
    h = _cplx(rng, (b, n_rx, n_rxa, n_tx, n_s, 14, n_eff), np.sqrt(0.5))
    no = (0.05 + 0.1 * rng.random(b)).astype(np.float32)
    tb, jb = LMMSEPostEqualizationSINR(trg, tsm), \
        jofdm.LMMSEPostEqualizationSINR(jrg, jsm)
    for whiten in (True, False):
        got = tb(torch.as_tensor(h), torch.as_tensor(no),
                 interference_whitening=whiten)
        want = np.asarray(jb(h, no, interference_whitening=whiten))
        assert got.shape == want.shape == (b, 14, n_eff, n_rx, n_s)
        # SINRs up to ~100 from f32 solves: relative to the largest
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=EQ_RTOL * want.max())
    # the helpers of the base class, one by one
    tp_, jp_ = PostEqualizationSINR(trg, tsm), \
        jofdm.PostEqualizationSINR(jrg, jsm)
    (td, tu), (jd, ju) = tp_.get_per_rx_channels(torch.as_tensor(h)), \
        jp_.get_per_rx_channels(jnp.asarray(h))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    no5 = (0.1 + rng.random(td.shape[:-1])).astype(np.float32)
    np.testing.assert_allclose(
        tp_.compute_interference_covariance_matrix(
            torch.as_tensor(no5), tu).numpy(),
        np.asarray(jp_.compute_interference_covariance_matrix(no5, ju)),
        rtol=0, atol=1e-5)
    f = _cplx(rng, td.shape[:-2] + (td.shape[-1], td.shape[-2]))
    np.testing.assert_allclose(
        tp_.compute_sinr(td, tu, torch.as_tensor(no5), torch.as_tensor(f)
                         ).numpy(),
        np.asarray(jp_.compute_sinr(jd, ju, no5, f)), rtol=1e-4, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tp_(torch.as_tensor(h), torch.as_tensor(no))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_resource_grid_demapper_matches_jax(name):
    _, assoc, n_s, _ = GRIDS[name]
    jrg, trg = _grids(name)
    jsm = jmimo.StreamManagement(np.array(assoc), n_s)
    tsm = StreamManagement(np.array(assoc), n_s)
    rng = np.random.default_rng(9)
    x = _cplx(rng, (3, trg.num_tx, trg.num_streams_per_tx,
                    trg.num_data_symbols))
    grid = ResourceGridMapper(trg)(torch.as_tensor(x))
    for data_dim in (False, True):
        g = torch.stack([grid, 2 * grid], -1) if data_dim else grid
        got = ResourceGridDemapper(trg, tsm)(g)
        want = np.asarray(jofdm.ResourceGridDemapper(jrg, jsm)(g.numpy()))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # the demapper inverts the mapper (one stream per receiver)
    if trg.num_tx == 1:
        np.testing.assert_array_equal(
            ResourceGridDemapper(trg, tsm)(grid).numpy(), x)


# LMMSE interpolation. With the TDL covariances (complex128) both
# packages run in f64: the batched solves and sums agree to ~1e-13 (the
# solves' condition number, at most (lambda_max(R) + 0.1) / 0.01 ~ 1e4
# here, times f64's 1.1e-16, times the matrix size). With complex64
# covariances both run in f32: the same bound with f32's 6e-8 is ~6e-4
# relative; measured 1.1e-5 at |h| <= 2.8 on these inputs.
LMMSE_F64_ATOL, LMMSE_F32_ATOL = 1e-9, 1e-3
N_SYM, N_SC = 6, 8


def _lmmse_setup(zero_pilot=False):
    """The pilot layout of tests/test_lmmse_ordered.py: two pilot
    symbols on alternating subcarriers, one pilot optionally zero."""
    from sionna_tpu.phy.ofdm import PilotPattern as JPilotPattern
    from sionna_tpu_torch.phy.ofdm import PilotPattern
    rng = np.random.default_rng(3)
    mask = np.zeros((1, 1, N_SYM, N_SC), bool)
    mask[0, 0, 1, 0::2] = True
    mask[0, 0, 4, 1::2] = True
    num_p = int(mask.sum())
    pilots = ((rng.standard_normal(num_p) + 1j * rng.standard_normal(num_p))
              / np.sqrt(2)).astype(np.complex64)
    if zero_pilot:
        pilots[1] = 0.0
    pilots = pilots.reshape(1, 1, -1)
    r_f = tdl_freq_cov_mat("A", 1e6 / N_SC, N_SC, 1e-7)
    r_t = tdl_time_cov_mat("A", 2.5, 3.5e9, 1e-4, N_SYM)
    h_p = _cplx(rng, (2, 1, 3, 1, 1, num_p))
    # error variances at a realistic noise level (>= 1e-2)
    err_p = rng.uniform(0.01, 0.1, h_p.shape)
    return (JPilotPattern(mask, pilots), PilotPattern(mask, pilots), r_f,
            r_t, h_p, err_p)


@pytest.mark.parametrize("precision", ["double", "single"])
@pytest.mark.parametrize("last_step", [True, False])
def test_lmmse_interpolator_1d_matches_jax(precision, last_step):
    rng = np.random.default_rng(11)
    r = tdl_freq_cov_mat("A", 1e6 / N_SC, N_SC, 1e-7)
    if precision == "single":
        r = r.astype(np.complex64)
    # 0 = data, 1 = pilot, 2 = unused; row 2 has no pilot
    pmask = np.zeros((1, 2, 4, N_SC), np.int64)
    pmask[0, 0, 0, 0::2] = 1
    pmask[0, 0, 1, 1::3] = 1
    pmask[0, 0, 3, :] = 1
    pmask[0, 1, :, 1::2] = 1
    pmask[0, 1, 2, 3] = 2
    h = _cplx(rng, (2, 1, 2, 1, 2, 4, N_SC))
    ev = rng.uniform(0.01, 0.1, h.shape).astype(np.float32)
    want_h, want_e = jofdm.LMMSEInterpolator1D(pmask, r, last_step)(h, ev)
    got_h, got_e = LMMSEInterpolator1D(pmask, r, last_step)(
        torch.as_tensor(h), torch.as_tensor(ev))
    atol = LMMSE_F64_ATOL if precision == "double" else LMMSE_F32_ATOL
    assert got_h.dtype == {"double": torch.complex128,
                           "single": torch.complex64}[precision]
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("last_step", [True, False])
def test_spatial_channel_filter_matches_jax(last_step):
    rng = np.random.default_rng(12)
    r = (np.eye(3) + 0.3 * (np.eye(3, k=1) + np.eye(3, k=-1))
         + 0.1j * (np.eye(3, k=1) - np.eye(3, k=-1)))
    h = _cplx(rng, (2, 1, 1, 1, N_SYM, N_SC, 3))
    ev = rng.uniform(0.01, 0.1, h.shape)
    want_h, want_e = jofdm.SpatialChannelFilter(r, last_step)(h, ev)
    got_h, got_e = SpatialChannelFilter(r, last_step)(torch.as_tensor(h),
                                                      torch.as_tensor(ev))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=LMMSE_F64_ATOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=0,
                               atol=LMMSE_F64_ATOL)


@pytest.mark.parametrize("order", ["t-f", "f-t", "t-f-s"])
@pytest.mark.parametrize("zero_pilot", [False, True])
def test_lmmse_interpolator_matches_jax(order, zero_pilot):
    jpp, tpp, r_f, r_t, h_p, err_p = _lmmse_setup(zero_pilot)
    r_s = np.eye(3) + 0.3 * (np.eye(3, k=1) + np.eye(3, k=-1))
    ji = jofdm.LMMSEInterpolator(jpp, r_t, r_f, cov_mat_space=r_s,
                                 order=order)
    ti = LMMSEInterpolator(tpp, r_t, r_f, cov_mat_space=r_s, order=order)
    want_h, want_e = jax.jit(ji.__call__)(h_p, err_p)
    got_h, got_e = ti(torch.as_tensor(h_p), torch.as_tensor(err_p))
    assert got_h.shape == want_h.shape == (2, 1, 3, 1, 1, N_SYM, N_SC)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=LMMSE_F64_ATOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=0,
                               atol=LMMSE_F64_ATOL)


def test_lmmse_interpolator_in_the_estimator_and_validation():
    """The ordered interpolator behind LSChannelEstimator (which hands it
    the broadcast err_var) on the flagship grid, against JAX; and the
    order checks."""
    jrg, trg = _grids("flagship")
    r_f = tdl_freq_cov_mat("A", 30e3, trg.num_effective_subcarriers, 1e-7)
    r_t = tdl_time_cov_mat("A", 3 / 3.6, 3.5e9, trg.ofdm_symbol_duration, 14)
    rng = np.random.default_rng(13)
    y = _cplx(rng, (2, 1, 1, 14, trg.fft_size))
    no = np.float32(0.05)
    th, tev = LSChannelEstimator(trg, interpolator=LMMSEInterpolator(
        trg.pilot_pattern, r_t, r_f))(torch.as_tensor(y), torch.tensor(no))
    jh, jev = jax.jit(jofdm.LSChannelEstimator(
        jrg, interpolator=jofdm.LMMSEInterpolator(jrg.pilot_pattern, r_t,
                                                  r_f)))(jnp.asarray(y), no)
    assert th.shape == jh.shape == (2, 1, 1, 1, 1, 14, trg.fft_size)
    # LS in f32 (a few ULP), then the f64 passes
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=LS_ATOL)
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=0,
                               atol=LS_ATOL)
    for order, kw in (("f", {}), ("f-f", {}), ("t-f-s", {}), ("t-x", {})):
        with pytest.raises(ValueError):
            LMMSEInterpolator(trg.pilot_pattern, r_t, r_f, order=order, **kw)
