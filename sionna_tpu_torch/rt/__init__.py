"""Ray tracing (RT): the PyTorch port of ``sionna_tpu.rt``.

Scenes are host NumPy triangle soups; a solver moves the geometry to its
device (``config.device`` by default, the card) once per solve, and the
compute path (ray-triangle intersection, the clustered acceleration
structure, image-method refinement, polarized field transfer) runs there
as plain torch; the renderer casts its camera rays through the same
intersection code. Mitsuba 3 XML bundles load and export on the host."""

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
from .render import render
from .mitsuba_loader import (load_ply, load_mitsuba_xml,
                             export_mitsuba_xml)
