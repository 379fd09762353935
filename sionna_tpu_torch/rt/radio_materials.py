"""Radio materials for ray tracing.

PyTorch-port counterpart of ``sionna_tpu/rt/radio_materials.py`` (a copy
of its host code: the port imports nothing of the JAX package).

Electromagnetic properties follow the ITU-R P.2040-3 frequency-
dependent model: relative permittivity eps_r = a * f_GHz^b and
conductivity sigma = c * f_GHz^d [S/m].
"""


__all__ = ["RadioMaterial", "ITU_MATERIALS"]

# ITU-R P.2040-3 Table 3 coefficients (a, b, c, d)
_ITU_COEFFS = {
    "vacuum": (1.0, 0.0, 0.0, 0.0),
    "itu_concrete": (5.24, 0.0, 0.0462, 0.7822),
    "itu_brick": (3.91, 0.0, 0.0238, 0.16),
    "itu_plasterboard": (2.73, 0.0, 0.0085, 0.9395),
    "itu_wood": (1.99, 0.0, 0.0047, 1.0718),
    "itu_glass": (6.31, 0.0, 0.0036, 1.3394),
    "itu_ceiling_board": (1.48, 0.0, 0.0011, 1.0750),
    "itu_chipboard": (2.58, 0.0, 0.0217, 0.7800),
    "itu_plywood": (2.71, 0.0, 0.33, 0.0),
    "itu_marble": (7.074, 0.0, 0.0055, 0.9262),
    "itu_floorboard": (3.66, 0.0, 0.0044, 1.3515),
    "itu_metal": (1.0, 0.0, 1e7, 0.0),
    "itu_very_dry_ground": (3.0, 0.0, 0.00015, 2.52),
    "itu_medium_dry_ground": (15.0, -0.1, 0.035, 1.63),
    "itu_wet_ground": (30.0, -0.4, 0.15, 1.30),
}


class RadioMaterial:
    """Material with ITU-style frequency-dependent EM properties.

    Either pass a known ITU name, or explicit
    ``relative_permittivity`` / ``conductivity`` (then frequency
    independent).  ``scattering_coefficient`` in [0, 1] diverts a
    fraction s^2 of the reflected energy to diffuse scattering;
    ``scattering_pattern`` selects its re-radiation lobe
    (default ``LambertianPattern``; see ``rt/scattering_pattern.py``).
    """

    def __init__(self, name, relative_permittivity=None,
                 conductivity=None, scattering_coefficient=0.0,
                 thickness=0.1, scattering_pattern=None):
        if scattering_pattern is None:
            from .scattering_pattern import LambertianPattern
            scattering_pattern = LambertianPattern()
        self.scattering_pattern = scattering_pattern
        self._name = name
        self._coeffs = _ITU_COEFFS.get(name)
        if self._coeffs is None and (relative_permittivity is None
                                     or conductivity is None):
            raise ValueError(
                f"Unknown material '{name}'. Provide "
                "relative_permittivity and conductivity, or use one "
                f"of {sorted(_ITU_COEFFS)}")
        self._eps_r = relative_permittivity
        self._sigma = conductivity
        self.scattering_coefficient = float(scattering_coefficient)
        self.thickness = float(thickness)

    @property
    def name(self):
        return self._name

    def relative_permittivity(self, frequency):
        """Real relative permittivity at ``frequency`` [Hz]"""
        if self._eps_r is not None:
            return float(self._eps_r)
        a, b, _, _ = self._coeffs
        return a * (frequency / 1e9) ** b

    def conductivity(self, frequency):
        """Conductivity [S/m] at ``frequency`` [Hz]"""
        if self._sigma is not None:
            return float(self._sigma)
        _, _, c, d = self._coeffs
        return c * (frequency / 1e9) ** d

    def complex_relative_permittivity(self, frequency):
        """eta = eps_r - j sigma / (omega eps_0)"""
        eps_r = self.relative_permittivity(frequency)
        sigma = self.conductivity(frequency)
        # sigma/(omega eps0) = 17.98 sigma / f_GHz
        return eps_r - 1j * 17.98 * sigma / (frequency / 1e9)

    def __repr__(self):
        return f"RadioMaterial(name={self._name!r})"


ITU_MATERIALS = {name: RadioMaterial(name) for name in _ITU_COEFFS}
