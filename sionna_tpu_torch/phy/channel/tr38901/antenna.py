"""TR 38.901 antenna elements, panels and panel arrays (counterpart of
``sionna_tpu/phy/channel/tr38901/antenna.py``).

Element positions are computed on the host with NumPy; the field
patterns are torch functions of the angles they are given, evaluated by
the channel coefficient generator. None of these objects has trainable
parameters. ``PanelArray.show`` (plotting) is not ported yet (ROADMAP.md,
queue 1 item 22).
"""

import math

import numpy as np
import torch

from ...block import Object
from ...constants import PI, SPEED_OF_LIGHT

__all__ = ["AntennaElement", "AntennaPanel", "PanelArray", "Antenna",
           "AntennaArray"]


class AntennaElement(Object):
    """Single antenna element with an "omni" or "38.901" pattern and a
    polarization slant angle (TR 38.901 model-2 polarization,
    Eq. 7.3-4/7.3-5)."""

    def __init__(self, pattern, slant_angle=0.0, precision=None):
        super().__init__(precision=precision)
        if pattern not in ("omni", "38.901"):
            raise ValueError(
                'The radiation_pattern must be one of ["omni", "38.901"]')
        self._pattern = pattern
        self._slant_angle = float(slant_angle)

    def radiation_pattern(self, theta, phi):
        """Power radiation pattern A(theta, phi) in linear scale."""
        theta = torch.as_tensor(theta).to(self.rdtype)
        phi = torch.as_tensor(phi).to(device=theta.device, dtype=self.rdtype)
        if self._pattern == "omni":
            return torch.ones_like(theta)
        # TR 38.901 Table 7.3-1
        theta_3db = phi_3db = 65 / 180 * PI
        a_max = sla_v = 30.0
        g_e_max = 8.0
        a_v = -torch.clamp_max(12 * ((theta - PI / 2) / theta_3db) ** 2,
                               sla_v)
        a_h = -torch.clamp_max(12 * (phi / phi_3db) ** 2, a_max)
        a_db = -torch.clamp_max(-(a_v + a_h), a_max) + g_e_max
        return torch.pow(10.0, a_db / 10)

    def field(self, theta, phi):
        """(F_theta, F_phi) field components, in float64: the JAX
        package scales the pattern by NumPy (float64) cosines, which
        promotes them."""
        a = torch.sqrt(self.radiation_pattern(theta, phi)).to(torch.float64)
        return (a * math.cos(self._slant_angle),
                a * math.sin(self._slant_angle))


class AntennaPanel(Object):
    """Rectangular panel of antenna elements on the y-z plane, centered
    at the origin."""

    def __init__(self, num_rows, num_cols, polarization,
                 vertical_spacing, horizontal_spacing, precision=None):
        super().__init__(precision=precision)
        if polarization not in ("single", "dual"):
            raise ValueError(
                "polarization must be either 'single' or 'dual'")
        self._num_rows = int(num_rows)
        self._num_cols = int(num_cols)
        self._polarization = polarization
        self._vertical_spacing = float(vertical_spacing)
        self._horizontal_spacing = float(horizontal_spacing)

        p = 1 if polarization == "single" else 2
        n = num_rows * num_cols
        ant_pos = np.zeros([n * p, 3])
        for i in range(num_rows):
            for j in range(num_cols):
                ant_pos[i + j * num_rows] = [
                    0, j * horizontal_spacing, -i * vertical_spacing]
        offset = [0, -(num_cols - 1) * horizontal_spacing / 2,
                  (num_rows - 1) * vertical_spacing / 2]
        ant_pos += offset
        if polarization == "dual":
            ant_pos[n:] = ant_pos[:n]
        self._ant_pos = ant_pos

    @property
    def ant_pos(self):
        return self._ant_pos

    @property
    def num_rows(self):
        return self._num_rows

    @property
    def num_cols(self):
        return self._num_cols

    @property
    def polarization(self):
        return self._polarization

    @property
    def vertical_spacing(self):
        return self._vertical_spacing

    @property
    def horizontal_spacing(self):
        return self._horizontal_spacing


class PanelArray(Object):
    """Array of antenna panels per TR 38.901."""

    def __init__(self, num_rows_per_panel, num_cols_per_panel,
                 polarization, polarization_type, antenna_pattern,
                 carrier_frequency, num_rows=1, num_cols=1,
                 panel_vertical_spacing=None,
                 panel_horizontal_spacing=None,
                 element_vertical_spacing=None,
                 element_horizontal_spacing=None, precision=None):
        super().__init__(precision=precision)
        if polarization not in ("single", "dual"):
            raise ValueError(
                "polarization must be either 'single' or 'dual'")
        if element_vertical_spacing is None:
            element_vertical_spacing = 0.5
        if element_horizontal_spacing is None:
            element_horizontal_spacing = 0.5
        if panel_vertical_spacing is None:
            panel_vertical_spacing = (num_rows_per_panel - 1) \
                * element_vertical_spacing + 0.5
        if panel_horizontal_spacing is None:
            panel_horizontal_spacing = (num_cols_per_panel - 1) \
                * element_horizontal_spacing + 0.5
        if panel_horizontal_spacing <= (num_cols_per_panel - 1) \
                * element_horizontal_spacing:
            raise ValueError("Panel horizontal spacing must be larger "
                             "than the panel width")
        if panel_vertical_spacing <= (num_rows_per_panel - 1) \
                * element_vertical_spacing:
            raise ValueError("Panel vertical spacing must be larger "
                             "than panel height")

        self._num_rows = int(num_rows)
        self._num_cols = int(num_cols)
        self._num_rows_per_panel = int(num_rows_per_panel)
        self._num_cols_per_panel = int(num_cols_per_panel)
        self._polarization = polarization
        self._polarization_type = polarization_type
        self._panel_vertical_spacing = float(panel_vertical_spacing)
        self._panel_horizontal_spacing = float(panel_horizontal_spacing)
        self._element_vertical_spacing = float(element_vertical_spacing)
        self._element_horizontal_spacing = float(
            element_horizontal_spacing)
        self._lambda_0 = SPEED_OF_LIGHT / carrier_frequency

        self._num_panels = self._num_rows * self._num_cols
        p = 1 if polarization == "single" else 2
        self._num_panel_ant = (self._num_rows_per_panel
                               * self._num_cols_per_panel * p)
        self._num_ant = self._num_panels * self._num_panel_ant

        if polarization == "single":
            if polarization_type not in ("V", "H"):
                raise ValueError("For single polarization, "
                                 "polarization_type must be 'V' or 'H'")
            slant_angle = 0 if polarization_type == "V" else PI / 2
            self._ant_pol1 = AntennaElement(antenna_pattern, slant_angle,
                                            self.precision)
            self._ant_pol2 = None
        else:
            if polarization_type not in ("VH", "cross"):
                raise ValueError(
                    "For dual polarization, polarization_type must be "
                    "'VH' or 'cross'")
            slant_angle = 0 if polarization_type == "VH" else -PI / 4
            self._ant_pol1 = AntennaElement(antenna_pattern, slant_angle,
                                            self.precision)
            self._ant_pol2 = AntennaElement(antenna_pattern,
                                            slant_angle + PI / 2,
                                            self.precision)

        # compose the array from panels
        ant_pos = np.zeros([self._num_ant, 3])
        panel = AntennaPanel(num_rows_per_panel, num_cols_per_panel,
                             polarization, element_vertical_spacing,
                             element_horizontal_spacing, self.precision)
        pos = panel.ant_pos
        count = 0
        for j in range(num_cols):
            for i in range(num_rows):
                offset = [0, j * panel_horizontal_spacing,
                          -i * panel_vertical_spacing]
                ant_pos[count * self._num_panel_ant:
                        (count + 1) * self._num_panel_ant] = pos + offset
                count += 1
        offset = [0, -(num_cols - 1) * panel_horizontal_spacing / 2,
                  (num_rows - 1) * panel_vertical_spacing / 2]
        ant_pos += offset
        ant_pos *= self._lambda_0
        self._ant_pos = ant_pos

        ind = np.arange(self._num_ant).reshape(
            [self._num_panels * p, -1])
        self._ant_ind_pol1 = ind[::p].reshape(-1)
        if polarization == "single":
            self._ant_ind_pol2 = np.array([], int)
        else:
            self._ant_ind_pol2 = ind[1:self._num_panels * p:2].reshape(-1)
        self._ant_pos_pol1 = ant_pos[self._ant_ind_pol1]
        self._ant_pos_pol2 = ant_pos[self._ant_ind_pol2]

    @property
    def num_rows(self):
        return self._num_rows

    @property
    def num_cols(self):
        return self._num_cols

    @property
    def num_rows_per_panel(self):
        return self._num_rows_per_panel

    @property
    def num_cols_per_panel(self):
        return self._num_cols_per_panel

    @property
    def polarization(self):
        return self._polarization

    @property
    def polarization_type(self):
        return self._polarization_type

    @property
    def panel_vertical_spacing(self):
        return self._panel_vertical_spacing

    @property
    def panel_horizontal_spacing(self):
        return self._panel_horizontal_spacing

    @property
    def element_vertical_spacing(self):
        return self._element_vertical_spacing

    @property
    def element_horizontal_spacing(self):
        return self._element_horizontal_spacing

    @property
    def num_panels(self):
        return self._num_panels

    @property
    def num_panels_ant(self):
        return self._num_panel_ant

    @property
    def num_ant(self):
        return self._num_ant

    @property
    def ant_pol1(self):
        return self._ant_pol1

    @property
    def ant_pol2(self):
        if self._polarization != "dual":
            raise ValueError(
                "This property is not defined with single polarization")
        return self._ant_pol2

    @property
    def ant_pos(self):
        return self._ant_pos

    @property
    def ant_ind_pol1(self):
        return self._ant_ind_pol1

    @property
    def ant_ind_pol2(self):
        if self._polarization != "dual":
            raise ValueError(
                "This property is not defined with single polarization")
        return self._ant_ind_pol2

    @property
    def ant_pos_pol1(self):
        return self._ant_pos_pol1

    @property
    def ant_pos_pol2(self):
        if self._polarization != "dual":
            raise ValueError(
                "This property is not defined with single polarization")
        return self._ant_pos_pol2

    def numpy_structure(self):
        """The element positions (in metres) and the antenna indices of
        each polarization, for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        return {"ant_pos": self._ant_pos,
                "ant_ind_pol1": self._ant_ind_pol1,
                "ant_ind_pol2": self._ant_ind_pol2}


class Antenna(PanelArray):
    """Single antenna."""

    def __init__(self, polarization, polarization_type, antenna_pattern,
                 carrier_frequency, precision=None):
        super().__init__(num_rows_per_panel=1, num_cols_per_panel=1,
                         polarization=polarization,
                         polarization_type=polarization_type,
                         antenna_pattern=antenna_pattern,
                         carrier_frequency=carrier_frequency,
                         precision=precision)


class AntennaArray(PanelArray):
    """Single-panel antenna array."""

    def __init__(self, num_rows, num_cols, polarization,
                 polarization_type, antenna_pattern, carrier_frequency,
                 vertical_spacing=None, horizontal_spacing=None,
                 precision=None):
        super().__init__(num_rows_per_panel=num_rows,
                         num_cols_per_panel=num_cols,
                         polarization=polarization,
                         polarization_type=polarization_type,
                         antenna_pattern=antenna_pattern,
                         carrier_frequency=carrier_frequency,
                         element_vertical_spacing=vertical_spacing,
                         element_horizontal_spacing=horizontal_spacing,
                         precision=precision)
