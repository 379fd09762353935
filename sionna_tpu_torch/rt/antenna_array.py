"""Antenna patterns and planar arrays for ray tracing.

PyTorch counterpart of ``sionna_tpu/rt/antenna_array.py``. Patterns
return the complex zenith/azimuth field components (E_theta, E_phi) in
the antenna's local spherical basis; arrays add per-element position
phase offsets at the carrier wavelength.
"""

import numpy as np
import torch

from ..phy.constants import PI

__all__ = ["PlanarArray", "antenna_pattern"]


def _pattern_iso(theta, phi, slant):
    c = torch.cos(slant)
    s = torch.sin(slant)
    one = torch.ones_like(theta)
    return one * c, one * s


def _pattern_dipole(theta, phi, slant):
    """Short dipole (vertical when slant=0): E_theta ~ sin(theta),
    gain 1.5."""
    g = np.sqrt(1.5) * torch.sin(theta)
    return g * torch.cos(slant), g * torch.sin(slant)


def _pattern_hw_dipole(theta, phi, slant):
    """Half-wave dipole: gain 1.643."""
    st = torch.sin(theta)
    st = torch.where(torch.abs(st) < 1e-6, 1e-6, st)
    g = np.sqrt(1.643) * torch.cos(PI / 2 * torch.cos(theta)) / st
    return g * torch.cos(slant), g * torch.sin(slant)


def _pattern_tr38901(theta, phi, slant):
    """3GPP TR 38.901 element pattern (Table 7.3-1), 8 dBi max."""
    theta_deg = theta * 180. / PI
    phi_deg = torch.remainder(phi * 180. / PI + 180., 360.) - 180.
    a_v = -torch.clamp(12. * ((theta_deg - 90.) / 65.) ** 2, max=30.)
    a_h = -torch.clamp(12. * (phi_deg / 65.) ** 2, max=30.)
    a_db = -torch.clamp(-(a_v + a_h), max=30.) + 8.
    g = torch.sqrt(torch.pow(10., a_db / 10.))
    return g * torch.cos(slant), g * torch.sin(slant)


_PATTERNS = {"iso": _pattern_iso, "dipole": _pattern_dipole,
             "hw_dipole": _pattern_hw_dipole,
             "tr38901": _pattern_tr38901}


def _as_real(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(x, np.float64))


def antenna_pattern(pattern, theta, phi, slant_angle=0.0):
    """Evaluates a named antenna pattern.

    Returns (E_theta, E_phi) for zenith angles ``theta`` and azimuth
    ``phi`` [rad]."""
    if pattern not in _PATTERNS:
        raise ValueError(f"Unknown pattern '{pattern}'. Must be one "
                         f"of {sorted(_PATTERNS)}")
    theta = _as_real(theta)
    return _PATTERNS[pattern](theta, _as_real(phi, theta),
                              _as_real(slant_angle, theta))


class PlanarArray:
    """Planar antenna array in the Y-Z plane (API parity with
    sionna.rt.PlanarArray).

    polarization: "V" | "H" | "VH" | "cross". Dual-polarized
    configurations instantiate two colocated elements per position
    with slant angles (0, pi/2) for "VH" or (-pi/4, pi/4) for
    "cross".
    """

    def __init__(self, num_rows, num_cols, vertical_spacing=0.5,
                 horizontal_spacing=0.5, pattern="iso",
                 polarization="V"):
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.vertical_spacing = float(vertical_spacing)
        self.horizontal_spacing = float(horizontal_spacing)
        if pattern not in _PATTERNS:
            raise ValueError(f"Unknown pattern '{pattern}'")
        self.pattern = pattern
        if polarization not in ("V", "H", "VH", "cross"):
            raise ValueError(
                "polarization must be 'V', 'H', 'VH' or 'cross'")
        self.polarization = polarization
        if polarization == "V":
            self._slant_angles = [0.0]
        elif polarization == "H":
            self._slant_angles = [PI / 2]
        elif polarization == "VH":
            self._slant_angles = [0.0, PI / 2]
        else:
            self._slant_angles = [-PI / 4, PI / 4]

    @property
    def num_ant(self):
        """Total number of antenna ports (positions x polarizations)"""
        return (self.num_rows * self.num_cols
                * len(self._slant_angles))

    @property
    def slant_angles(self):
        """[num_ant] slant angle per antenna port"""
        base = np.array(self._slant_angles)
        return np.tile(base, self.num_rows * self.num_cols)

    def positions(self, wavelength):
        """[num_ant, 3] element positions [m] in the local frame
        (array in the Y-Z plane, boresight +x), centered."""
        dv = self.vertical_spacing * wavelength
        dh = self.horizontal_spacing * wavelength
        rows = np.arange(self.num_rows) - (self.num_rows - 1) / 2
        cols = np.arange(self.num_cols) - (self.num_cols - 1) / 2
        y = np.repeat(cols * dh, self.num_rows)
        z = np.tile(rows[::-1] * dv, self.num_cols)
        pos = np.stack([np.zeros_like(y), y, z], axis=-1)
        # duplicate positions for each polarization port
        return np.repeat(pos, len(self._slant_angles), axis=0)

    def field(self, theta, phi):
        """Pattern of every port at directions (theta [...], phi):
        returns (E_theta, E_phi), each [..., num_ant], in the dtype and
        on the device of ``theta``."""
        theta = _as_real(theta)
        slants = torch.as_tensor(self.slant_angles, dtype=theta.dtype,
                                 device=theta.device)
        return _PATTERNS[self.pattern](theta[..., None],
                                       _as_real(phi, theta)[..., None],
                                       slants)
