"""The ray tracer's scene side in the PyTorch port against the JAX
package, on the CPU: every built-in scene and the procedural city
(triangles and materials bit-identical), OBJ loading, the scene API,
radio materials, antenna patterns and arrays, scattering patterns,
wedge extraction and the host geometry helpers.

Tolerances: scenes, materials, wedges and host helpers are the same
NumPy code, so they are compared exactly; antenna and scattering
patterns (float64 torch against float64 XLA) within PAT_RTOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sionna_tpu.rt as jrt
import sionna_tpu.rt.geometry as jgeo
import sionna_tpu.rt.scattering_pattern as jsp
import sionna_tpu_torch.rt as trt
import sionna_tpu_torch.rt.geometry as tgeo
import sionna_tpu_torch.rt.scattering_pattern as tsp

torch.set_num_threads(2)

PAT_RTOL = 1e-12

SCENES = ["simple_reflector", "double_reflector", "simple_wedge", "box",
          "simple_street_canyon", "etoile", "city_grid", "empty"]


def _same_scene(got, want):
    assert got.name == want.name and got.frequency == want.frequency
    assert got.triangles.dtype == want.triangles.dtype
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert [m.name for m in got.triangle_materials] == \
        [m.name for m in want.triangle_materials]


@pytest.mark.parametrize("name", SCENES)
def test_builtin_scenes_are_bit_identical(name):
    _same_scene(trt.load_scene(name, frequency=2.4e9),
                jrt.load_scene(name, frequency=2.4e9))
    assert getattr(trt.scene, name) == name


def test_make_city_is_bit_identical():
    got = trt.make_city(3, 3, subdiv=2)
    _same_scene(got, jrt.make_city(3, 3, subdiv=2))
    assert got.num_triangles == 2 * (3 * 3 * 5 * 4 + 4)


def test_obj_loading_and_scene_api(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "usemtl itu_glass\nf 1 2 3 4\nusemtl unknown\n"
                    "f 1/1 3/1 4/1\n")
    got = trt.load_scene(str(path))
    _same_scene(got, jrt.load_scene(str(path)))
    assert got.num_triangles == 3
    got.add(trt.Transmitter("tx", [0., 0., 1.]))
    got.add(trt.Receiver("rx", [1., 1., 1.]))
    got.add(trt.Camera("cam", [5., 5., 5.]))
    got.get("tx").look_at(got.get("rx"))
    np.testing.assert_allclose(got.get("tx").orientation,
                               [np.pi / 4, -np.arctan2(0, np.sqrt(2)), 0.])
    got.set_material("itu_metal", [0])
    assert got.triangle_materials[0].name == "itu_metal"
    # per-scene material instances
    got.get("itu_metal").scattering_coefficient = 0.5
    assert trt.ITU_MATERIALS["itu_metal"].scattering_coefficient == 0.
    got.remove("cam")
    assert list(got.cameras) == []
    got.bandwidth = 20e6
    assert got.bandwidth == 20e6
    with pytest.raises(KeyError):
        got.get("nothing")
    with pytest.raises(NotImplementedError, match="item 21 \\(c\\)"):
        got.render()
    with pytest.raises(NotImplementedError, match="item 21 \\(c\\)"):
        got.preview()
    xml = tmp_path / "scene.xml"
    xml.write_text("<scene/>")
    with pytest.raises(NotImplementedError, match="item 21 \\(c\\)"):
        trt.load_scene(str(xml))


def test_radio_materials_match_jax():
    for name, mat in trt.ITU_MATERIALS.items():
        want = jrt.ITU_MATERIALS[name]
        for f in (1e9, 3.5e9, 28e9):
            assert mat.complex_relative_permittivity(f) == \
                want.complex_relative_permittivity(f)
    custom = trt.RadioMaterial("mine", 4., 0.1, thickness=0.2)
    assert custom.complex_relative_permittivity(2e9) == \
        jrt.RadioMaterial("mine", 4., 0.1).complex_relative_permittivity(2e9)
    with pytest.raises(ValueError):
        trt.RadioMaterial("nothing")


@pytest.mark.parametrize("pattern", ["iso", "dipole", "hw_dipole",
                                     "tr38901"])
@pytest.mark.parametrize("polarization", ["V", "H", "VH", "cross"])
def test_planar_array_matches_jax(pattern, polarization):
    rng = np.random.default_rng(0)
    theta = rng.uniform(0., np.pi, (5, 7))
    phi = rng.uniform(-np.pi, np.pi, (5, 7))
    got = trt.PlanarArray(2, 3, 0.7, 0.5, pattern, polarization)
    want = jrt.PlanarArray(2, 3, 0.7, 0.5, pattern, polarization)
    assert got.num_ant == want.num_ant
    np.testing.assert_array_equal(got.positions(0.1), want.positions(0.1))
    np.testing.assert_array_equal(got.slant_angles, want.slant_angles)
    g = got.field(torch.as_tensor(theta), torch.as_tensor(phi))
    w = want.field(jnp.asarray(theta), jnp.asarray(phi))
    for a, b in zip(g, w):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PAT_RTOL, atol=1e-15)
    g = trt.antenna_pattern(pattern, theta, phi, 0.3)
    w = jrt.antenna_pattern(pattern, theta, phi, 0.3)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PAT_RTOL, atol=1e-15)


@pytest.mark.parametrize("make", [
    lambda m: m.LambertianPattern(),
    lambda m: m.DirectivePattern(4),
    lambda m: m.BackscatteringPattern(3, 6, 0.4)])
def test_scattering_patterns_match_jax(make):
    rng = np.random.default_rng(1)
    n = np.array([0., 0., 1.])
    k_i = rng.normal(size=(50, 3))
    k_i[:, 2] = -np.abs(k_i[:, 2])
    k_i /= np.linalg.norm(k_i, axis=1, keepdims=True)
    k_s = rng.normal(size=(50, 3))
    k_s[:, 2] = np.abs(k_s[:, 2])
    k_s /= np.linalg.norm(k_s, axis=1, keepdims=True)
    got, want = make(tsp), make(jsp)
    assert got.canonical() == want.canonical()
    np.testing.assert_allclose(
        got(torch.as_tensor(k_i), torch.as_tensor(k_s),
            torch.as_tensor(n)).numpy(),
        np.asarray(want(jnp.asarray(k_i), jnp.asarray(k_s),
                        jnp.asarray(n))), rtol=PAT_RTOL)
    packed_t = tsp.pack_patterns([got, tsp.LambertianPattern()])
    packed_j = jsp.pack_patterns([want, jsp.LambertianPattern()])
    for key in packed_j:
        np.testing.assert_array_equal(packed_t[key], packed_j[key])


@pytest.mark.parametrize("name", ["simple_street_canyon", "simple_wedge",
                                  "box", "etoile"])
def test_extract_wedges_matches_jax(name):
    tri = jrt.load_scene(name).triangles
    got, want = trt.extract_wedges(tri), jrt.extract_wedges(tri)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["origin"].shape[0] > 0


def test_host_geometry_helpers_match_jax():
    np.testing.assert_array_equal(tgeo.fibonacci_sphere(1000),
                                  jgeo.fibonacci_sphere(1000))
    np.testing.assert_array_equal(tgeo.rot_matrix([0.3, -0.2, 1.1]),
                                  jgeo.rot_matrix([0.3, -0.2, 1.1]))
    # the port's rot_matrix also takes a stack of orientations
    ori = np.random.default_rng(5).uniform(-np.pi, np.pi, (7, 3))
    np.testing.assert_array_equal(
        tgeo.rot_matrix(ori), np.stack([jgeo.rot_matrix(o) for o in ori]))
    v = tgeo.fibonacci_sphere(200)
    got, want = tgeo.sph_basis(torch.as_tensor(v)), \
        jgeo.sph_basis(jnp.asarray(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    for a, b in zip(tgeo.unit_to_angles(torch.as_tensor(v)),
                    jgeo.unit_to_angles(jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    lengths = np.array([1.5, 1234.5678, 9.87654321e4])
    np.testing.assert_allclose(
        tgeo.phase_exp(torch.as_tensor(lengths), 0.0857).numpy(),
        np.asarray(jgeo.phase_exp(jnp.asarray(lengths), 0.0857)),
        rtol=0, atol=1e-6)
    assert tgeo.real_dtype("cpu") == torch.float64
    assert tgeo.real_dtype("cuda") == torch.float32


def test_material_table_matches_triangle_materials():
    """``Scene.material_table`` (the port's per-material evaluation of
    per-triangle properties) gives each triangle its material, also
    after ``set_material``."""
    scene = trt.load_scene("simple_street_canyon")
    for ids in (None, [0, 3, 4]):
        if ids is not None:
            scene.set_material("itu_metal", ids)
        mats, idx = scene.material_table()
        assert idx.shape == (scene.num_triangles,)
        assert [mats[i] for i in idx] == scene.triangle_materials
    assert [m.name for m in scene.triangle_materials[:5]] == \
        ["itu_metal", "itu_medium_dry_ground", "itu_concrete",
         "itu_metal", "itu_metal"]
