"""The ray tracer's gain output, differentiable solver, path container
and radio map in the PyTorch port against the JAX package, on the CPU:
``PathSolver(output="gain")`` with and without its valid-pair compaction,
``trace_functional``'s gradients, ``Paths.cir``/``cfr``/``taps``, and
``RadioMapSolver``'s map, RSS, SINR and position draws.

Tolerances:
- tau: TAU_RTOL relative; CIRs, CFRs, taps: A_RTOL of the largest
  magnitude (complex64 products in another order);
- gains and radio maps: GAIN_RTOL relative where the gain is above
  1e-15;
- gradients: GRAD_RTOL of the largest (float64 positions through
  complex64 fields); torch's gradient for the complex permittivity is
  the conjugate of ``jax.grad``'s (the two conventions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.rt as jrt
import sionna_tpu_torch.rt as trt
import sionna_tpu_torch.rt.scattering as tscat
import sionna_tpu_torch.rt.solver as tsolver
from sionna_tpu_torch.phy.config import config as torch_config
from test_torch_rt_solver import (A_RTOL, CANYON, TAU_RTOL, _both, _close,
                                  _jax_phases)

torch.set_num_threads(2)

GAIN_RTOL = 1e-4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _solvers_on_cpu():
    """The port's solvers default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


@pytest.mark.parametrize("compact", [False, True])
def test_gain_output_matches_jax_and_paths(monkeypatch, compact):
    if compact:
        monkeypatch.setattr(tsolver, "GAIN_COMPACT_MIN_PAIRS", 0)
    rx = [[float(x), float(y), 1.5] for x in (-30., 0., 25.)
          for y in (-6., 0., 7.)]
    sj, st = _both("simple_street_canyon", CANYON[0], rx, frequency=3.5e9)
    for sc in (sj, st):
        sc.get("itu_concrete").scattering_coefficient = 0.2
    kw = dict(max_depth=2, samples_per_src=2000, diffuse_reflection=True,
              diffuse_samples=128)
    monkeypatch.setattr(tscat, "draw_scatter_phases", _jax_phases)
    got = trt.PathSolver(device="cpu")(st, output="gain", **kw)
    want = np.asarray(jrt.PathSolver()(sj, output="gain", **kw))
    assert got.shape == (9, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=GAIN_RTOL)
    # the paths' incoherent reduction (no duplicate paths here)
    paths = trt.PathSolver(device="cpu")(st, **kw)
    np.testing.assert_allclose(
        got.numpy(), tsolver._gain(paths.a).numpy(), rtol=GAIN_RTOL)


def test_trace_functional_gradients_match_jax():
    sj, st = _both("simple_reflector", [[-5., 0., 5.]], [[5., 1., 5.]],
                   frequency=3e9)
    for sc in (sj, st):
        sc.set_material("itu_concrete")
    fn_j, args_j = jrt.PathSolver().trace_functional(
        sj, max_depth=1, samples_per_src=2000)
    fn_t, args_t = trt.PathSolver(device="cpu").trace_functional(
        st, max_depth=1, samples_per_src=2000)

    def loss_j(*args):
        a, _, valid = fn_j(*args)
        return jnp.sum(jnp.where(valid[:, None, :, None], jnp.abs(a) ** 2,
                                 0.))

    args = [x.clone().requires_grad_(True) for x in args_t]
    a, tau, valid = fn_t(*args)
    a_j, tau_j, valid_j = jax.jit(fn_j)(*args_j)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(tau.detach().numpy(), np.asarray(tau_j),
                               rtol=TAU_RTOL)
    _close(a, a_j, A_RTOL)
    loss = torch.sum(torch.where(valid[:, None, :, None],
                                 torch.abs(a) ** 2, 0.))
    loss.backward()
    grads_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(*args_j)
    for x, g_j in zip(args, grads_j):
        g_j = np.asarray(g_j)
        g_t = x.grad.numpy()
        if np.iscomplexobj(g_j):
            g_j = np.conj(g_j)
        _close(g_t, g_j, GRAD_RTOL)
    assert np.all(args[1].grad.numpy()[0] != 0.)


def test_paths_cir_cfr_taps_match_jax():
    sj, st = _both("simple_street_canyon", *CANYON, frequency=3.5e9)
    kw = dict(max_depth=2, samples_per_src=2000)
    got = trt.PathSolver(device="cpu")(st, **kw)
    want = jrt.PathSolver()(sj, **kw)
    for norm in (False, True):
        a, tau = got.cir(sampling_frequency=1e3, num_time_steps=4,
                         normalize_delays=norm)
        a_j, tau_j = want.cir(sampling_frequency=1e3, num_time_steps=4,
                              normalize_delays=norm, out_type="numpy")
        assert isinstance(a, torch.Tensor) and a.dtype == torch.complex64
        _close(a, a_j, A_RTOL)
        np.testing.assert_allclose(tau.numpy(), tau_j, rtol=TAU_RTOL,
                                   atol=1e-18)
        a_n, _ = got.cir(normalize_delays=norm, out_type="numpy")
        assert isinstance(a_n, np.ndarray)
    freqs = np.linspace(-5e6, 5e6, 33)
    _close(got.cfr(freqs, num_time_steps=2, normalize=True),
           want.cfr(freqs, num_time_steps=2, normalize=True,
                    out_type="numpy"), A_RTOL)
    _close(got.taps(20e6, -3, 12, num_time_steps=2),
           want.taps(20e6, -3, 12, num_time_steps=2, out_type="numpy"),
           A_RTOL)


def test_radio_map_matches_jax():
    sj, st = _both("simple_street_canyon", [[-20., 0., 10.], [30., 3., 8.]],
                   [[0., 0., 1.5]], frequency=3.5e9)
    kw = dict(cell_size=(4., 3.), size=(80., 24.), center=(0., 0.),
              max_depth=2, samples_per_src=2000)
    got = trt.RadioMapSolver(device="cpu")(st, **kw)
    want = jrt.RadioMapSolver()(sj, **kw)
    np.testing.assert_array_equal(got.cell_centers, want.cell_centers)
    pg = np.asarray(want.path_gain)
    assert got.path_gain.shape == pg.shape == (2, 8, 20)
    live = pg > 1e-15
    assert live.sum() > 250
    for g, w in ((got.path_gain, pg), (got.rss, np.asarray(want.rss))):
        np.testing.assert_allclose(g.numpy()[live], w[live],
                                   rtol=GAIN_RTOL)
    np.testing.assert_allclose(got.sinr.numpy(), np.asarray(want.sinr),
                               rtol=GAIN_RTOL)
    for metric, kw_s in (("path_gain", dict(min_val_db=-100.)),
                         ("sinr", dict(min_dist=10., max_dist=40.))):
        pos, cells = got.sample_positions(20, metric=metric, seed=3, **kw_s)
        pos_j, cells_j = want.sample_positions(20, metric=metric, seed=3,
                                               **kw_s)
        np.testing.assert_array_equal(cells, cells_j)
        np.testing.assert_array_equal(pos, pos_j)
    with pytest.raises(NotImplementedError, match="item 22"):
        got.show()
    # the solver left the scene as it was
    assert list(st.receivers) == ["rx0"]


def test_solvers_default_to_config_device():
    assert trt.PathSolver().device == torch.device("cpu")
    assert trt.RadioMapSolver().device == torch.device("cpu")
    torch_config.device = "meta"
    try:
        assert trt.PathSolver().device == torch.device("meta")
    finally:
        torch_config.device = "cpu"
