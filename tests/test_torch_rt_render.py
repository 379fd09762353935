"""The ray-cast renderer of the PyTorch port against the JAX package, on
the CPU (float64 geometry in both): the canyon and a small city (the
clustered acceleration structure forced) with device markers, ``clip_at``,
the radio-map overlay for each metric, an empty scene, ``preview`` and the
per-material albedo.

Tolerances:
- pixels: PIXEL_ATOL absolute, except pixels whose ray meets the edge two
  triangles share (either triangle may be reported there, and the two are
  shaded differently): those are counted and must stay under
  EDGE_PIXEL_SHARE of the image;
- the albedo: bit-identical.
"""

import importlib

import numpy as np
import pytest
import torch

import sionna_tpu.rt as jrt
import sionna_tpu_torch.rt as trt
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.rt.geometry import moller_trumbore

# the modules: each package's ``rt.render`` attribute is the function
jrender = importlib.import_module("sionna_tpu.rt.render")
trender = importlib.import_module("sionna_tpu_torch.rt.render")

torch.set_num_threads(2)

PIXEL_ATOL = 1e-6
EDGE_PIXEL_SHARE = 0.005
RES = (64, 48)


@pytest.fixture(autouse=True, scope="module")
def _render_on_cpu():
    """The port's renderer defaults to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def _scene(mod, scene, cam_pos, look_at, tx=None, rx=None):
    sc = mod.load_scene(scene) if isinstance(scene, str) else scene
    if tx is not None:
        sc.add(mod.Transmitter("tx", tx))
    if rx is not None:
        sc.add(mod.Receiver("rx", rx))
    cam = mod.Camera("cam", cam_pos)
    cam.look_at(look_at)
    sc.add(cam)
    return sc


def _edge_pixels(scene, resolution, clip_at=None):
    """[h, w] mask of the pixels whose ray hits two or more triangles at
    its nearest distance (a shared edge or vertex)."""
    cam = next(iter(scene.cameras.values()))
    orig, dirs = trender.camera_rays(cam, resolution, 45.)
    tri = np.asarray(scene.triangles)
    if clip_at is not None:
        tri = tri[tri.mean(axis=1)[:, 2] <= clip_at]
    t, hit = moller_trumbore(torch.as_tensor(orig), torch.as_tensor(dirs),
                             torch.as_tensor(tri))
    t = torch.where(hit, t, torch.inf)
    t_min = t.min(dim=1, keepdim=True).values
    ties = (torch.isfinite(t) & (t - t_min <= 1e-9 * t_min.abs())).sum(1)
    return (ties >= 2).numpy().reshape(resolution[1], resolution[0])


def _assert_image_matches(got, want, edges):
    assert got.shape == want.shape and got.dtype == np.float32
    bad = np.abs(got - want).max(-1) > PIXEL_ATOL
    assert not (bad & ~edges).any(), np.argwhere(bad & ~edges)[:5]
    assert bad.mean() < EDGE_PIXEL_SHARE, bad.mean()


@pytest.mark.parametrize("name", ["canyon", "city"])
def test_render_matches_jax(name, monkeypatch):
    if name == "canyon":
        args = ("simple_street_canyon", [-60., 0., 30.], [0., 0., 5.],
                [-20., 0., 10.], [20., 5., 1.5])
        scenes = [_scene(m, *args) for m in (jrt, trt)]
    else:
        # 168 triangles, the accelerated path forced in both packages
        monkeypatch.setattr(jrender, "ACCEL_MIN_TRIS", 64)
        monkeypatch.setattr(trender, "ACCEL_MIN_TRIS", 64)
        scenes = [_scene(m, m.make_city(2, 2, subdiv=2), [0., -60., 40.],
                         [0., 0., 5.], [-16., -16., 30.], [0., 0., 1.5])
                  for m in (jrt, trt)]
    want = np.asarray(scenes[0].render(resolution=RES))
    got = scenes[1].render(resolution=RES)
    _assert_image_matches(got, want, _edge_pixels(scenes[1], RES))
    sky = np.all(got == np.float32(trender._SKY), axis=-1)
    assert 0.02 < sky.mean() < 0.98
    for color in (trender.TX_COLOR, trender.RX_COLOR):
        assert np.all(got == np.float32(color), axis=-1).any()


def test_clip_at_and_fov_match_jax():
    args = ("simple_street_canyon", [0., -50., 40.], [0., 0., 0.],
            [-20., 0., 10.])
    js, ts = _scene(jrt, *args), _scene(trt, *args)
    for kw in (dict(clip_at=5.), dict(fov=70., resolution=(40, 40))):
        res = kw.get("resolution", RES)
        want = np.asarray(js.render(**{"resolution": RES, **kw}))
        got = ts.render(**{"resolution": RES, **kw})
        _assert_image_matches(got, want,
                              _edge_pixels(ts, res, kw.get("clip_at")))
    full = ts.render(resolution=RES)
    assert not np.array_equal(full, ts.render(resolution=RES, clip_at=5.))


@pytest.fixture(scope="module")
def jax_radio_map():
    sc = jrt.load_scene("simple_street_canyon", frequency=3.5e9)
    sc.tx_array = jrt.PlanarArray(1, 1, pattern="iso", polarization="V")
    sc.rx_array = jrt.PlanarArray(1, 1, pattern="iso", polarization="V")
    sc.add(jrt.Transmitter("tx", [-20., 0., 10.]))
    sc.add(jrt.Transmitter("tx2", [25., -3., 12.]))
    return jrt.RadioMapSolver()(sc, cell_size=(4., 4.), size=(60., 60.),
                                center=(0., 0., 1.5), max_depth=1,
                                samples_per_src=5000)


@pytest.mark.parametrize("metric,kw", [
    ("path_gain", dict(rm_vmin=-110., clip_at=10.)),
    ("rss", dict(rm_tx=1)),
    ("sinr", dict(rm_vmin=-20., rm_vmax=40.))])
def test_radio_map_overlay_matches_jax(jax_radio_map, metric, kw):
    """The overlay of one map (JAX's, handed to the port's ``RadioMap``)
    drawn by both renderers."""
    jrm = jax_radio_map
    trm = trt.RadioMap(torch.as_tensor(np.asarray(jrm.path_gain)),
                       np.asarray(jrm.cell_centers), [44., 44.])
    args = ("simple_street_canyon", [-60., 0., 30.], [0., 0., 5.],
            [-20., 0., 10.])
    js, ts = _scene(jrt, *args), _scene(trt, *args)
    want = np.asarray(js.render(resolution=RES, radio_map=jrm,
                                rm_metric=metric, **kw))
    got = ts.render(resolution=RES, radio_map=trm, rm_metric=metric, **kw)
    _assert_image_matches(got, want,
                          _edge_pixels(ts, RES, kw.get("clip_at")))
    plain = ts.render(resolution=RES, clip_at=kw.get("clip_at"))
    assert (np.abs(got - plain).max(-1) > 0).mean() > 0.1


def test_empty_scene_is_sky():
    """No geometry: pure sky, and a device's marker over it."""
    for tx in (None, [0., 0., 10.]):
        js, ts = (_scene(m, m.Scene(name="empty"), [0., -10., 12.],
                         [0., 0., 10.], tx=tx) for m in (jrt, trt))
        got = ts.render(resolution=(32, 24))
        np.testing.assert_array_equal(
            got, np.asarray(js.render(resolution=(32, 24))))
        sky = np.all(got == np.float32(trender._SKY), axis=-1)
        marker = np.all(got == np.float32(trender.TX_COLOR), axis=-1)
        assert (sky | marker).all()
        assert marker.any() == (tx is not None)


def test_preview_equals_render_and_errors():
    ts = _scene(trt, "simple_street_canyon", [0., -50., 40.], [0., 0., 0.])
    np.testing.assert_array_equal(ts.preview(resolution=(32, 24)),
                                  ts.render(resolution=(32, 24)))
    with pytest.raises(ValueError, match="no camera"):
        trt.load_scene("box").render()
    with pytest.raises(ValueError, match="rm_metric"):
        trm = trt.RadioMap(torch.ones(1, 2, 2),
                           np.zeros((2, 2, 3)), [44.])
        ts.render(resolution=(8, 6), radio_map=trm, rm_metric="snr")


def test_material_albedo_is_bit_identical():
    names = list(trt.ITU_MATERIALS) + ["custom_metal", "my_wood", "x"]
    assert len(names) > 10
    for name in names:
        got = trender._material_albedo(name)
        assert np.array_equal(got, jrender._material_albedo(name)), name
