"""OFDM blocks of the PyTorch port against the JAX package on the same
inputs: the row-column interleaver, the Kronecker pilots, resource-grid
mapping, nulled-subcarrier removal and nearest-neighbour interpolation
bit-exact; LS estimation and LMMSE equalization to f32 rounding."""

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
from sionna_tpu_torch.phy.ofdm import (LMMSEEqualizer, LSChannelEstimator,
                                       NearestNeighborInterpolator,
                                       RemoveNulledSubcarriers, ResourceGrid,
                                       ResourceGridMapper)
from sionna_tpu_torch.phy.utils import ebnodb2no, load_numpy_state
from sionna_tpu_torch.phy.utils.linalg import (_matmul, cholesky_solve,
                                               inv_cholesky)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LSChannelEstimator(trg, interpolation_type="lin")


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
