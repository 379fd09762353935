"""Ray tracing (RT): the PyTorch port of ``sionna_tpu.rt``.

Scenes are host NumPy triangle soups; a solver moves the geometry to its
device (``config.device`` by default, the card) once per solve, and the
compute path (ray-triangle intersection, the clustered acceleration
structure, image-method refinement, polarized field transfer) runs there
as plain torch. The renderer and the Mitsuba loader are not ported yet
(ROADMAP.md queue 1, item 21 (c))."""

from .scene import (Scene, Transmitter, Receiver, Camera, load_scene,
                    scene, make_city)
from .diffraction import extract_wedges
from .antenna_array import PlanarArray, antenna_pattern
from .radio_materials import RadioMaterial, ITU_MATERIALS
from .scattering_pattern import (ScatteringPattern, LambertianPattern,
                                 DirectivePattern,
                                 BackscatteringPattern)
from .solver import PathSolver, Paths
from .radio_map import RadioMapSolver, RadioMap
