"""The Mitsuba XML + PLY loader and exporter of the PyTorch port against
the JAX package's (host NumPy in both): the committed fixture
(``tests/data/mitsuba_fixture``, exported from the procedural street
canyon), PLY files written by one package and read by the other (binary
and ASCII), ``to_world`` transforms, inline BSDFs, OBJ shapes, the
exporter's bytes, and a small path solve of the loaded fixture.

Tolerances: triangles, materials and files exact; the solve as
``tests/test_torch_rt_solver.py`` holds it (valid paths exact, tau
TAU_RTOL relative, coefficients A_RTOL of the largest).
"""

import os

import numpy as np
import pytest
import torch

import sionna_tpu.rt as jrt
import sionna_tpu.rt.mitsuba_loader as jml
import sionna_tpu_torch.rt as trt
import sionna_tpu_torch.rt.mitsuba_loader as tml
from sionna_tpu_torch.phy.config import config as torch_config

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "mitsuba_fixture", "street_canyon.xml")
TAU_RTOL = 1e-9
A_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _solvers_on_cpu():
    """The port's solvers default to the card (``config.device``); these
    tests ask for the CPU."""
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


def test_fixture_loads_as_jax_and_as_the_procedural_canyon():
    tris, mats = tml.load_mitsuba_xml(FIXTURE)
    jtris, jmats = jml.load_mitsuba_xml(FIXTURE)
    assert tris.dtype == np.float64 and np.array_equal(tris, jtris)
    assert mats == jmats
    sc = trt.load_scene(FIXTURE, frequency=3.5e9)
    ref = trt.load_scene("simple_street_canyon")
    assert sc.name == "street_canyon" and sc.frequency == 3.5e9
    assert np.array_equal(sc.triangles, ref.triangles)
    assert [m.name for m in sc.triangle_materials] == \
        [m.name for m in ref.triangle_materials]
    assert {m.name for m in sc.triangle_materials} == \
        {"itu_concrete", "itu_medium_dry_ground"}


_ASCII_PLY = (
    "ply\nformat ascii 1.0\ncomment written by hand\n"
    "element vertex 5\n"
    "property float x\nproperty float y\nproperty float z\n"
    "property float nx\n"
    "element face 2\n"
    "property list uchar int vertex_indices\n"
    "end_header\n"
    "0 0 0 1\n1 0 0 1\n1 1 0.5 1\n0 1 0 1\n0.25 0.5 2 1\n"
    "4 0 1 2 3\n3 1 2 4\n")


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_binary_ply_read_back_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, size=(9, 3)).astype(np.int64)
    mods = {"port": tml, "jax": jml}
    path = str(tmp_path / "m.ply")
    mods[writer]._write_ply(path, verts, faces)
    v, f = mods[reader].load_ply(path)
    assert v.dtype == np.float64 and f.dtype == np.int64
    np.testing.assert_array_equal(v, verts.astype(np.float64))
    np.testing.assert_array_equal(f, faces)
    other = str(tmp_path / "o.ply")
    mods[reader]._write_ply(other, verts, faces)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_ascii_ply_and_ngon_faces_match_jax(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text(_ASCII_PLY)
    v, f = tml.load_ply(str(path))
    jv, jf = jml.load_ply(str(path))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    # the quad fan-triangulated into two triangles, then the triangle
    assert f.tolist() == [[0, 1, 2], [0, 2, 3], [1, 2, 4]]
    assert v.shape == (5, 3)
    for bad, match in (("plx\n", "not a PLY"),
                       (_ASCII_PLY.replace("ascii", "binary_big_endian"),
                        "unsupported"),
                       (_ASCII_PLY.replace("end_header\n", ""),
                        "unterminated")):
        path.write_text(bad)
        with pytest.raises(ValueError, match=match):
            tml.load_ply(str(path))


def _one_triangle_scene(tmp_path, body):
    verts = np.asarray([[1., 0., 0.], [0., 1., 0.], [0., 0., 1.]],
                       np.float32)
    tml._write_ply(str(tmp_path / "t.ply"), verts,
                   np.asarray([[0, 1, 2]], np.int64))
    xml = tmp_path / "s.xml"
    xml.write_text('<?xml version="1.0"?>\n<scene version="2.1.0">\n'
                   + body + "\n</scene>")
    return str(xml), verts


@pytest.mark.parametrize("case", ["srt", "matrix16", "matrix9_mirror",
                                  "scale_xyz_shape_id", "obj"])
def test_transforms_and_materials_match_jax(tmp_path, case):
    bodies = {
        "srt": '''<bsdf type="twosided" id="mat-itu_metal"/>
  <shape type="ply" id="mesh-itu_metal">
    <string name="filename" value="t.ply"/>
    <transform name="to_world">
      <scale value="2"/>
      <rotate z="1" angle="90"/>
      <translate x="10" y="-5" z="1"/>
    </transform>
    <ref id="mat-itu_metal" name="bsdf"/>
  </shape>''',
        "matrix16": '''<shape type="ply">
    <string name="filename" value="t.ply"/>
    <transform name="to_world">
      <matrix value="1 0 0 5  0 1 0 0  0 0 1 0  0 0 0 1"/>
    </transform>
    <bsdf type="twosided" id="mat-itu_glass"/>
  </shape>''',
        "matrix9_mirror": '''<shape type="ply">
    <string name="filename" value="t.ply"/>
    <transform name="to_world">
      <matrix value="-1 0 0 0 1 0 0 0 1"/>
      <lookat origin="0 0 0" target="1 0 0"/>
    </transform>
    <bsdf type="diffuse" id="unknown_material"/>
  </shape>''',
        "scale_xyz_shape_id": '''<shape type="ply" id="wall-itu_wood-3">
    <string name="filename" value="t.ply"/>
    <transform name="toWorld">
      <scale x="1" y="3" z="0.5"/>
    </transform>
  </shape>''',
        "obj": '''<shape type="obj" id="mesh-itu_brick">
    <string name="filename" value="t.obj"/>
    <transform name="to_world"><translate value="1 2 3"/></transform>
  </shape>''',
    }
    xml, verts = _one_triangle_scene(tmp_path, bodies[case])
    (tmp_path / "t.obj").write_text(
        "v 0 0 0\nv 2 0 0\nv 2 2 0\nv 0 2 0\nusemtl itu_brick\nf 1 2 3 4\n")
    tris, mats = tml.load_mitsuba_xml(xml, default_material="itu_wet_ground")
    jtris, jmats = jml.load_mitsuba_xml(xml,
                                        default_material="itu_wet_ground")
    np.testing.assert_array_equal(tris, jtris)
    assert mats == jmats
    expect = {
        # applied in document order: scale, rotate, translate
        "srt": (np.asarray([[10., -3., 1.], [8., -5., 1.], [10., -5., 3.]]),
                "itu_metal"),
        "matrix16": (verts + np.asarray([5., 0., 0.]), "itu_glass"),
        "scale_xyz_shape_id": (verts * np.asarray([1., 3., .5]),
                               "itu_wood"),
        "obj": (np.asarray([[1., 2., 3.], [3., 2., 3.], [3., 4., 3.]]),
                "itu_brick"),
        # a mirror reverses the winding, so the normals keep their side;
        # "lookat" is a camera transform and is skipped
        "matrix9_mirror": ((verts * np.asarray([-1., 1., 1.]))[::-1],
                           "itu_wet_ground"),
    }
    np.testing.assert_allclose(tris[0], expect[case][0], atol=1e-6)
    assert mats == [expect[case][1]] * len(mats)


def test_export_matches_jax_and_reimports(tmp_path):
    """The port's exporter writes JAX's bytes, and both loaders read the
    bundle back to the scene's triangles (float32-exact here)."""
    for name in ("box", "simple_street_canyon"):
        sc = trt.load_scene(name)
        path = tml.export_mitsuba_xml(sc, str(tmp_path / "t" / f"{name}.xml"))
        jpath = jml.export_mitsuba_xml(jrt.load_scene(name),
                                       str(tmp_path / "j" / f"{name}.xml"))
        for a, b in [(path, jpath)] + [
                (os.path.join(tmp_path, "t", "meshes", f),
                 os.path.join(tmp_path, "j", "meshes", f))
                for f in os.listdir(tmp_path / "t" / "meshes")]:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), a
        back = trt.load_scene(path)
        assert back.num_triangles == sc.num_triangles
        np.testing.assert_array_equal(back.triangles, sc.triangles)
        assert [m.name for m in back.triangle_materials] == \
            [m.name for m in sc.triangle_materials]
        np.testing.assert_array_equal(jml.load_mitsuba_xml(path)[0],
                                      back.triangles)


def test_city_round_trip_is_float32_exact(tmp_path):
    sc = trt.make_city(2, 2, subdiv=2)
    path = tml.export_mitsuba_xml(sc, str(tmp_path / "city.xml"))
    back = trt.load_scene(path)
    np.testing.assert_array_equal(
        back.triangles, sc.triangles.astype(np.float32).astype(np.float64))
    assert [m.name for m in back.triangle_materials] == \
        [m.name for m in sc.triangle_materials]


def _canyon(mod, scene):
    scene.tx_array = mod.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.rx_array = mod.PlanarArray(1, 1, pattern="iso", polarization="V")
    scene.add(mod.Transmitter("tx", [-20., 0., 10.]))
    scene.add(mod.Receiver("rx", [20., 5., 1.5]))
    return mod.PathSolver()(scene, max_depth=2, samples_per_src=2000)


def test_loaded_fixture_solves_as_jax_and_as_the_canyon():
    got = _canyon(trt, trt.load_scene(FIXTURE, frequency=3.5e9))
    want = _canyon(jrt, jrt.load_scene(FIXTURE, frequency=3.5e9))
    twin = _canyon(trt, trt.load_scene("simple_street_canyon",
                                       frequency=3.5e9))
    for field in ("valid", "tau", "a", "interactions"):
        assert torch.equal(getattr(got, field), getattr(twin, field)), field
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    assert valid.sum() > 3
    np.testing.assert_array_equal(got.interactions.numpy(),
                                  np.asarray(want.interactions))
    np.testing.assert_allclose(got.tau.numpy()[valid],
                               np.asarray(want.tau)[valid], rtol=TAU_RTOL)
    a, ja = got.a.numpy(), np.asarray(want.a)
    assert np.abs(a - ja).max() <= A_RTOL * np.abs(ja).max()
