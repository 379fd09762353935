"""Scene representation for ray tracing.

PyTorch-port counterpart of ``sionna_tpu/rt/scene.py``: the same host
NumPy code (a copy, so every procedural scene is bit-identical to the JAX
package's). A scene is a triangle soup [num_tri, 3, 3] with a material
index per triangle, plus radio devices. Geometry lives host-side in
NumPy; a solver moves it to its device once per solve.

Built-in scenes are procedural (box, simple_street_canyon,
simple_reflector, simple_wedge, double_reflector, etoile, city_grid);
external meshes load from Wavefront OBJ files. Rendering and the Mitsuba
XML loader are not ported yet (ROADMAP.md queue 1, item 21 (c)).
"""

import copy
import os

import numpy as np

from ..phy.constants import SPEED_OF_LIGHT
from .radio_materials import RadioMaterial, ITU_MATERIALS

__all__ = ["Scene", "Transmitter", "Receiver", "Camera", "load_scene",
           "scene", "make_city"]


class _RadioDevice:
    def __init__(self, name, position, orientation=(0., 0., 0.),
                 velocity=(0., 0., 0.)):
        self.name = str(name)
        self.position = np.asarray(position, np.float64)
        self.orientation = np.asarray(orientation, np.float64)
        self.velocity = np.asarray(velocity, np.float64)

    def look_at(self, target):
        """Points the device towards ``target`` (position or
        device)."""
        if isinstance(target, _RadioDevice):
            target = target.position
        d = np.asarray(target, np.float64) - self.position
        yaw = np.arctan2(d[1], d[0])
        pitch = -np.arctan2(d[2], np.linalg.norm(d[:2]))
        self.orientation = np.array([yaw, pitch, 0.])


class Transmitter(_RadioDevice):
    """Transmitter radio device (API parity with
    sionna.rt.Transmitter)."""

    def __init__(self, name, position, orientation=(0., 0., 0.),
                 velocity=(0., 0., 0.), power_dbm=44.):
        super().__init__(name, position, orientation, velocity)
        self.power_dbm = float(power_dbm)


class Receiver(_RadioDevice):
    """Receiver radio device (API parity with sionna.rt.Receiver)."""


class Camera(_RadioDevice):
    """Camera for scene rendering; point it with ``look_at`` (the
    renderer itself is not ported yet: ROADMAP.md item 21 (c))."""


class Scene:
    """Container for geometry, materials, and radio devices."""

    def __init__(self, vertices=None, triangles=None,
                 material_names=None, frequency=3.5e9, name="scene"):
        # [num_tri, 3, 3] triangle vertices
        if triangles is None:
            self._triangles = np.zeros((0, 3, 3), np.float64)
        elif vertices is not None:
            self._triangles = np.asarray(vertices, np.float64)[
                np.asarray(triangles, np.int64)]
        else:
            self._triangles = np.asarray(triangles, np.float64)
        n_tri = self._triangles.shape[0]

        self._materials = {}
        if material_names is None:
            material_names = ["itu_concrete"] * n_tri
        self._tri_material_names = list(material_names)
        self._material_index = None
        for m in set(self._tri_material_names):
            # per-scene material instances: mutating e.g. the
            # scattering_coefficient must not leak into other scenes
            # through the shared ITU preset registry
            self._materials[m] = (copy.copy(ITU_MATERIALS[m])
                                  if m in ITU_MATERIALS
                                  else RadioMaterial(m))
        self.name = name
        self.frequency = float(frequency)
        self.tx_array = None
        self.rx_array = None
        self._transmitters = {}
        self._receivers = {}
        self._cameras = {}

    # ------------------------------------------------------------------
    @property
    def wavelength(self):
        return SPEED_OF_LIGHT / self.frequency

    @property
    def triangles(self):
        """[num_tri, 3, 3] triangle vertex positions [m]"""
        return self._triangles

    @property
    def num_triangles(self):
        return self._triangles.shape[0]

    @property
    def triangle_materials(self):
        """list of RadioMaterial, one per triangle"""
        return [self._materials[m] for m in self._tri_material_names]

    def material_table(self):
        """(materials, index): the scene's materials and each triangle's
        [num_tri] int64 index into that list, so that a per-triangle
        property is evaluated once per material."""
        if self._material_index is None:
            pos = {name: i for i, name in enumerate(self._materials)}
            self._material_index = np.array(
                [pos[m] for m in self._tri_material_names], np.int64)
        return list(self._materials.values()), self._material_index

    @property
    def radio_materials(self):
        """dict name -> RadioMaterial used in this scene"""
        return self._materials

    @property
    def transmitters(self):
        return self._transmitters

    @property
    def receivers(self):
        return self._receivers

    @property
    def cameras(self):
        return self._cameras

    def add(self, item):
        """Adds a Transmitter, Receiver or Camera."""
        if isinstance(item, Transmitter):
            self._transmitters[item.name] = item
        elif isinstance(item, Receiver):
            self._receivers[item.name] = item
        elif isinstance(item, Camera):
            self._cameras[item.name] = item
        elif isinstance(item, RadioMaterial):
            self._materials[item.name] = item
        else:
            raise TypeError(f"Cannot add object of type {type(item)}")

    def remove(self, name):
        """Removes a device by name."""
        for d in (self._transmitters, self._receivers, self._cameras):
            if name in d:
                del d[name]
                return
        raise KeyError(f"No device named '{name}'")

    def get(self, name):
        """Returns a device or material by name."""
        for d in (self._transmitters, self._receivers, self._cameras,
                  self._materials):
            if name in d:
                return d[name]
        raise KeyError(f"No object named '{name}'")

    def set_material(self, material_name, triangle_ids=None):
        """Assigns ``material_name`` to all or selected triangles."""
        if material_name not in self._materials:
            self._materials[material_name] = (
                copy.copy(ITU_MATERIALS[material_name])
                if material_name in ITU_MATERIALS
                else RadioMaterial(material_name))
        ids = range(self.num_triangles) if triangle_ids is None \
            else triangle_ids
        for i in ids:
            self._tri_material_names[i] = material_name
        self._material_index = None

    @property
    def bandwidth(self):
        """Transmission bandwidth [Hz] (upstream Scene.bandwidth;
        used e.g. for CFR sampling in the SYS_Meets_RT flow)."""
        return getattr(self, "_bandwidth", 1e6)

    @bandwidth.setter
    def bandwidth(self, value):
        self._bandwidth = float(value)

    def render(self, *args, **kwargs):
        """Not ported yet: ROADMAP.md queue 1, item 21 (c) (the
        ray-cast renderer)."""
        raise NotImplementedError(
            "Scene.render is not ported yet (ROADMAP.md queue 1, item 21 "
            "(c))")

    def preview(self, *args, **kwargs):
        """Not ported yet: ROADMAP.md queue 1, item 21 (c)."""
        raise NotImplementedError(
            "Scene.preview is not ported yet (ROADMAP.md queue 1, item 21 "
            "(c))")

    def __repr__(self):
        return (f"Scene(name={self.name!r}, "
                f"num_triangles={self.num_triangles}, "
                f"tx={len(self._transmitters)}, "
                f"rx={len(self._receivers)})")


# ----------------------------------------------------------------------
# Geometry helpers for procedural scenes
# ----------------------------------------------------------------------
def _quad(p0, p1, p2, p3):
    """Two triangles covering the (planar) quad p0-p1-p2-p3."""
    return [[p0, p1, p2], [p0, p2, p3]]


def _box_walls(x0, x1, y0, y1, z0, z1, skip=()):
    """Axis-aligned box faces as triangles; ``skip`` lists faces to
    omit from {'top','bottom','north','south','east','west'}."""
    t = []
    if "bottom" not in skip:
        t += _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0],
                   [x0, y1, z0])
    if "top" not in skip:
        t += _quad([x0, y0, z1], [x0, y1, z1], [x1, y1, z1],
                   [x1, y0, z1])
    if "south" not in skip:   # y = y0
        t += _quad([x0, y0, z0], [x0, y0, z1], [x1, y0, z1],
                   [x1, y0, z0])
    if "north" not in skip:   # y = y1
        t += _quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1],
                   [x0, y1, z1])
    if "west" not in skip:    # x = x0
        t += _quad([x0, y0, z0], [x0, y1, z0], [x0, y1, z1],
                   [x0, y0, z1])
    if "east" not in skip:    # x = x1
        t += _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1],
                   [x1, y1, z0])
    return t


def _make_simple_reflector():
    """A single 20x20 m metallic plate in the z=0 plane."""
    tris = _quad([-10., -10., 0.], [10., -10., 0.], [10., 10., 0.],
                 [-10., 10., 0.])
    return Scene(triangles=np.asarray(tris),
                 material_names=["itu_metal"] * len(tris),
                 name="simple_reflector")


def _make_double_reflector():
    """Two parallel metallic plates (z=0 and z=20) for double-bounce
    tests."""
    tris = _quad([-20., -20., 0.], [20., -20., 0.], [20., 20., 0.],
                 [-20., 20., 0.])
    tris += _quad([-20., -20., 20.], [-20., 20., 20.],
                  [20., 20., 20.], [20., -20., 20.])
    return Scene(triangles=np.asarray(tris),
                 material_names=["itu_metal"] * len(tris),
                 name="double_reflector")


def _make_simple_wedge():
    """Two perpendicular metallic half-planes meeting along the
    y-axis (corner reflector geometry)."""
    tris = _quad([0., -20., 0.], [20., -20., 0.], [20., 20., 0.],
                 [0., 20., 0.])
    tris += _quad([0., -20., 0.], [0., 20., 0.], [0., 20., 20.],
                  [0., -20., 20.])
    return Scene(triangles=np.asarray(tris),
                 material_names=["itu_metal"] * len(tris),
                 name="simple_wedge")


def _make_box():
    """Closed 10x10x3 m concrete room (indoor scenario)."""
    tris = _box_walls(-5., 5., -5., 5., 0., 3.)
    return Scene(triangles=np.asarray(tris),
                 material_names=["itu_concrete"] * len(tris),
                 name="box")


def _make_simple_street_canyon():
    """Street canyon: concrete ground plus two building rows flanking
    a 20 m-wide, 100 m-long street along the x-axis."""
    tris = _quad([-60., -40., 0.], [60., -40., 0.], [60., 40., 0.],
                 [-60., 40., 0.])
    mats = ["itu_medium_dry_ground"] * len(tris)
    # Buildings: walls facing the street at y = +/-10, height 20
    for y0, y1 in ((10., 30.), (-30., -10.)):
        walls = _box_walls(-50., 50., y0, y1, 0., 20.,
                           skip=("bottom",))
        tris += walls
        mats += ["itu_concrete"] * len(walls)
    return Scene(triangles=np.asarray(tris), material_names=mats,
                 name="simple_street_canyon")


def _make_etoile():
    """Plaza with buildings arranged radially around a central square
    (stylized stand-in for the upstream 'etoile' scene)."""
    tris = _quad([-120., -120., 0.], [120., -120., 0.],
                 [120., 120., 0.], [-120., 120., 0.])
    mats = ["itu_medium_dry_ground"] * len(tris)
    rng_angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    for ang in rng_angles:
        cx, cy = 60. * np.cos(ang), 60. * np.sin(ang)
        walls = _box_walls(cx - 12., cx + 12., cy - 12., cy + 12.,
                           0., 25., skip=("bottom",))
        tris += walls
        mats += ["itu_concrete"] * len(walls)
    return Scene(triangles=np.asarray(tris), material_names=mats,
                 name="etoile")


def _quad_grid(p0, p1, p2, p3, s):
    """Planar quad p0-p1-p2-p3 subdivided into an s x s grid
    (2*s^2 triangles) via bilinear interpolation."""
    p0, p1, p2, p3 = (np.asarray(p, np.float64)
                      for p in (p0, p1, p2, p3))
    u = np.linspace(0., 1., s + 1)
    v = np.linspace(0., 1., s + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")     # [s+1, s+1]
    pts = ((1 - uu)[..., None] * (1 - vv)[..., None] * p0
           + uu[..., None] * (1 - vv)[..., None] * p1
           + uu[..., None] * vv[..., None] * p2
           + (1 - uu)[..., None] * vv[..., None] * p3)
    a = pts[:-1, :-1]
    b = pts[1:, :-1]
    c = pts[1:, 1:]
    d = pts[:-1, 1:]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2], axis=0)


def make_city(nx=6, ny=6, subdiv=1, block=20., street=12.,
              height=15., frequency=3.5e9, ground_material=
              "itu_medium_dry_ground", wall_material="itu_concrete"):
    """Procedural Manhattan-grid city: ``nx * ny`` box buildings on a
    ground plane, every face subdivided into ``subdiv^2`` quads.
    Triangle count = 2*(nx*ny*5*subdiv^2 + subdiv^2); e.g.
    make_city(10, 10, 10) -> 100,200 triangles (city-scale stress
    geometry standing in for the upstream binary munich asset,
    SURVEY.md 2.12)."""
    pitch = block + street
    w = nx * pitch + street
    h = ny * pitch + street
    x0, y0 = -w / 2., -h / 2.
    tris = [_quad_grid([x0, y0, 0.], [x0 + w, y0, 0.],
                       [x0 + w, y0 + h, 0.], [x0, y0 + h, 0.],
                       subdiv)]
    mats = [ground_material] * tris[0].shape[0]
    rng = np.random.default_rng(7)
    for i in range(nx):
        for j in range(ny):
            bx = x0 + street + i * pitch
            by = y0 + street + j * pitch
            bz = height * (0.6 + 0.8 * rng.random())
            x1b, y1b = bx + block, by + block
            quads = [
                # roof
                ([bx, by, bz], [bx + block, by, bz],
                 [x1b, y1b, bz], [bx, y1b, bz]),
                # south / north
                ([bx, by, 0.], [x1b, by, 0.],
                 [x1b, by, bz], [bx, by, bz]),
                ([bx, y1b, 0.], [bx, y1b, bz],
                 [x1b, y1b, bz], [x1b, y1b, 0.]),
                # west / east
                ([bx, by, 0.], [bx, by, bz],
                 [bx, y1b, bz], [bx, y1b, 0.]),
                ([x1b, by, 0.], [x1b, y1b, 0.],
                 [x1b, y1b, bz], [x1b, by, bz]),
            ]
            for q in quads:
                t = _quad_grid(*q, subdiv)
                tris.append(t)
                mats += [wall_material] * t.shape[0]
    tris = np.concatenate(tris, axis=0)
    return Scene(triangles=tris, material_names=mats,
                 frequency=frequency,
                 name=f"city_{nx}x{ny}_s{subdiv}")


_BUILTIN_SCENES = {
    "simple_reflector": _make_simple_reflector,
    "double_reflector": _make_double_reflector,
    "simple_wedge": _make_simple_wedge,
    "box": _make_box,
    "simple_street_canyon": _make_simple_street_canyon,
    "etoile": _make_etoile,
    "city_grid": make_city,
    "empty": lambda: Scene(name="empty"),
}


class _SceneRegistry:
    """Attribute registry so users can write
    ``load_scene(sionna_tpu_torch.rt.scene.simple_street_canyon)``."""

    def __getattr__(self, name):
        if name in _BUILTIN_SCENES:
            return name
        raise AttributeError(
            f"Unknown built-in scene '{name}'. Available: "
            f"{sorted(_BUILTIN_SCENES)}")


scene = _SceneRegistry()


def load_obj(path, default_material="itu_concrete"):
    """Loads a Wavefront OBJ file as (triangles, material_names).
    Supports v/f records and usemtl grouping; polygons are fanned
    into triangles."""
    verts, tris, mats = [], [], []
    current_mat = default_material
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "usemtl":
                current_mat = parts[1]
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
                    mats.append(current_mat)
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    return verts[tris], mats


def load_scene(name="empty", frequency=3.5e9,
               default_material="itu_concrete"):
    """Loads a built-in procedural scene by name, or a Wavefront OBJ
    mesh by path (API parity with sionna.rt.load_scene). Mitsuba 3 XML
    bundles are not ported yet (ROADMAP.md queue 1, item 21 (c))."""
    if name in _BUILTIN_SCENES:
        sc = _BUILTIN_SCENES[name]()
        sc.frequency = float(frequency)
        return sc
    if os.path.isfile(name):
        if name.lower().endswith(".xml"):
            raise NotImplementedError(
                "Mitsuba XML scenes are not ported yet (ROADMAP.md queue "
                "1, item 21 (c)); export the mesh as OBJ")
        triangles, mats = load_obj(name, default_material)
        mats = [m if m in ITU_MATERIALS else default_material
                for m in mats]
        return Scene(triangles=triangles, material_names=mats,
                     frequency=frequency,
                     name=os.path.splitext(os.path.basename(name))[0])
    raise ValueError(
        f"'{name}' is neither a built-in scene "
        f"({sorted(_BUILTIN_SCENES)}) nor an existing file")
