"""The ray tracer's path solver in the PyTorch port against the JAX
package, on the CPU (float64 geometry, complex64 fields in both):
``PathSolver`` paths on three scenes with refraction on and off (with
antenna arrays, device orientation and velocity), diffraction, and
diffuse scattering fed JAX's random phases. The gain output,
``trace_functional``, ``Paths`` and ``RadioMapSolver`` are in
``test_torch_rt_radio_map.py``, which shares these helpers.

Tolerances:
- traced interactions, valid masks, path types: exact;
- tau: TAU_RTOL relative; angles and Doppler: ANGLE_ATOL;
- path coefficients: A_RTOL of the largest magnitude (complex64
  products in another order), except degenerate corner paths (see
  ``_degenerate``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sionna_tpu.rt as jrt
import sionna_tpu_torch.rt as trt
import sionna_tpu_torch.rt.scattering as tscat
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

TAU_RTOL = 1e-9
ANGLE_ATOL = 1e-9
A_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _solvers_on_cpu():
    """The port's solvers default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _scene(mod, name, tx, rx, arrays=None, city=None, **kw):
    sc = city if city is not None else mod.load_scene(name, **kw)
    tx_a, rx_a = arrays or ((1, 1, "iso", "V"), (1, 1, "iso", "V"))
    sc.tx_array = mod.PlanarArray(tx_a[0], tx_a[1], pattern=tx_a[2],
                                  polarization=tx_a[3])
    sc.rx_array = mod.PlanarArray(rx_a[0], rx_a[1], pattern=rx_a[2],
                                  polarization=rx_a[3])
    for i, p in enumerate(tx):
        sc.add(mod.Transmitter(f"tx{i}", p, velocity=(1., -2., 0.)))
    for i, p in enumerate(rx):
        sc.add(mod.Receiver(f"rx{i}", p, orientation=(0.3, 0.1, 0.),
                            velocity=(0., 3., 0.)))
    return sc


def _both(name, tx, rx, **kw):
    return _scene(jrt, name, tx, rx, **kw), _scene(trt, name, tx, rx, **kw)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.max(np.abs(want)))


def _degenerate(scene, paths):
    """[rx, tx, P] mask of valid specular paths with a segment shorter
    than 1e-9 m: a reflection at the line where two reflecting planes
    meet (a ground-wall corner), where two consecutive reflection points
    coincide. The zero-length segment has no direction, so the field
    the JAX package and the port give such a path depends on how each
    rounds (the sign of a zero in ``arctan2``): ROADMAP.md "Not
    faults". Computed here with NumPy from the path's triangles."""
    tri = scene.triangles
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    txs = [t.position for t in scene.transmitters.values()]
    rxs = [r.position for r in scene.receivers.values()]
    inter = _np(paths.interactions)
    valid = _np(paths.valid)
    types = _np(paths.types)
    out = np.zeros(valid.shape, bool)
    for r, t, p in zip(*np.nonzero(valid)):
        ids = [i for i in inter[p] if i >= 0]
        if types[p] != 1:
            continue
        images = [txs[t]]
        for i in ids:
            q = images[-1]
            images.append(q - 2. * np.dot(q - tri[i, 0], normals[i])
                          * normals[i])
        pts = [rxs[r]]
        for k in range(len(ids), 0, -1):
            i = ids[k - 1]
            seg = pts[-1] - images[k]
            t_par = np.dot(tri[i, 0] - images[k], normals[i]) \
                / np.dot(seg, normals[i])
            pts.append(images[k] + t_par * seg)
        pts.append(txs[t])
        seg_len = np.linalg.norm(np.diff(np.array(pts), axis=0), axis=1)
        out[r, t, p] = seg_len.min() < 1e-9
    return out


def _same_paths(got, want, scene):
    """Holds ``got`` to ``want``; returns the count of valid paths."""
    np.testing.assert_array_equal(_np(got.interactions),
                                  np.asarray(want.interactions))
    np.testing.assert_array_equal(_np(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(_np(got.types), np.asarray(want.types))
    np.testing.assert_allclose(_np(got.tau), np.asarray(want.tau),
                               rtol=TAU_RTOL)
    assert got.a.dtype == torch.complex64
    # degenerate corner paths: equal geometry, no comparable field
    keep = ~_degenerate(scene, want)[:, None, :, None, :]
    _close(_np(got.a) * keep, np.asarray(want.a) * keep, A_RTOL)
    for f in ("theta_t", "phi_t", "theta_r", "phi_r", "doppler"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ANGLE_ATOL, err_msg=f)
    return int(np.asarray(want.valid).sum())


CANYON = ([[-20., 0., 10.]], [[20., 5., 1.5], [5., -4., 2.]])


@pytest.mark.parametrize("name,tx,rx,depth,refraction,arrays", [
    ("simple_reflector", [[-5., 0., 5.]], [[5., 1., 5.]], 1, True, None),
    ("box", [[-2., 1., 1.5]], [[2., -1., 1.2]], 2, True,
     ((2, 1, "tr38901", "VH"), (1, 2, "dipole", "cross"))),
    ("box", [[-2., 1., 1.5]], [[2., -1., 1.2]], 2, False, None),
    ("simple_street_canyon", *CANYON, 3, True, None),
    ("simple_street_canyon", *CANYON, 3, False, None),
])
def test_paths_match_jax(name, tx, rx, depth, refraction, arrays):
    sj, st = _both(name, tx, rx, arrays=arrays, frequency=3.5e9)
    kw = dict(max_depth=depth, samples_per_src=3000, refraction=refraction)
    got = trt.PathSolver(device="cpu")(st, **kw)
    assert got.a.device.type == "cpu"
    n_valid = _same_paths(got, jrt.PathSolver()(sj, **kw), sj)
    assert n_valid >= 2


def test_diffraction_matches_jax():
    sj, st = _both("simple_wedge", [[10., 0., 5.]], [[5., 3., -5.]],
                   frequency=3e9)
    kw = dict(max_depth=1, samples_per_src=2000, diffraction=True)
    got = trt.PathSolver(device="cpu")(st, **kw)
    _same_paths(got, jrt.PathSolver()(sj, **kw), sj)
    assert (got.types == 2).sum() > 0 and got.valid[..., got.types == 2] \
        .any()


def _jax_phases(seed, num_samples, num_tx, num_rx, device):
    """The JAX package's draw of the scattered paths' phases
    (``sionna_tpu/rt/scattering.py``)."""
    key = jax.random.PRNGKey(seed)
    chi0 = jax.random.uniform(key, (num_samples, num_tx, num_rx),
                              jnp.float32, maxval=2. * np.pi)
    chi = jax.random.uniform(jax.random.fold_in(key, 1),
                             (num_samples, num_tx, num_rx, 2, 2),
                             jnp.float32, maxval=2. * np.pi)
    return (torch.as_tensor(np.array(chi0), device=device),
            torch.as_tensor(np.array(chi), device=device))


@pytest.mark.parametrize("refraction", [True, False])
def test_diffuse_scattering_matches_jax(monkeypatch, refraction):
    monkeypatch.setattr(tscat, "draw_scatter_phases", _jax_phases)
    sj, st = _both("simple_street_canyon", *CANYON, frequency=3.5e9)
    for sc in (sj, st):
        sc.get("itu_concrete").scattering_coefficient = 0.3
        sc.get("itu_concrete").scattering_pattern = \
            (jrt if sc is sj else trt).DirectivePattern(3)
        sc.get("itu_medium_dry_ground").scattering_coefficient = 0.2
    kw = dict(max_depth=1, samples_per_src=1000, diffuse_reflection=True,
              diffuse_samples=200, refraction=refraction)
    got = trt.PathSolver(device="cpu")(st, **kw)
    _same_paths(got, jrt.PathSolver()(sj, **kw), sj)
    assert got.valid[..., got.types == 3].sum() > 100


def test_port_draws_its_own_scatter_phases():
    chi0, chi = tscat.draw_scatter_phases(41, 300, 1, 2, "cpu")
    again, _ = tscat.draw_scatter_phases(41, 300, 1, 2, "cpu")
    assert torch.equal(chi0, again) and chi.shape == (300, 1, 2, 2, 2)
    assert 0. <= float(chi.min()) and float(chi.max()) < 2. * np.pi
    assert abs(float(chi.mean()) - np.pi) < 0.1
