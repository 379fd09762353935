"""UMa / UMi / RMa scenario parameterizations (counterpart of
``sionna_tpu/phy/channel/tr38901/scenarios.py``): NumPy on the host, the
JAX package's code, so that the LoS probability, pathloss and LSP
moments match it to the bit (see ``system_level_scenario.py``).
"""

import numpy as np

from ...config import config
from ...constants import PI, SPEED_OF_LIGHT
from .system_level_scenario import SystemLevelScenario

__all__ = ["UMaScenario", "UMiScenario", "RMaScenario"]

_log10 = np.log10


class UMaScenario(SystemLevelScenario):
    """3GPP TR 38.901 urban macrocell (UMa) scenario."""

    def clip_carrier_frequency_lsp(self, fc):
        return max(fc, 6.)

    @property
    def min_2d_in(self):
        return 0.0

    @property
    def max_2d_in(self):
        return 25.0

    @property
    def los_probability(self):
        h_ut = self.h_ut
        c = (np.maximum(h_ut - 13., 0.) / 10.) ** 1.5
        c = c[:, None, :]
        d_out = self._distance_2d_out
        with np.errstate(divide="ignore", invalid="ignore"):
            p = ((18.0 / d_out + np.exp(-d_out / 63.0)
                  * (1. - 18. / d_out))
                 * (1. + c * 5. / 4. * (d_out / 100.) ** 3
                    * np.exp(-d_out / 150.0)))
        return np.where(d_out < 18.0, 1.0, p)

    @property
    def rays_per_cluster(self):
        return 20

    @property
    def los_parameter_filepath(self):
        return "UMa_LoS.json"

    @property
    def nlos_parameter_filepath(self):
        return "UMa_NLoS.json"

    @property
    def o2i_parameter_filepath(self):
        return "UMa_O2I.json"

    def _compute_lsp_log_mean_std(self):
        batch_size, num_bs, num_ut = (self.batch_size, self.num_bs,
                                      self.num_ut)
        distance_2d = self.distance_2d
        h_ut = self.h_ut[:, None, :]

        log_mean_ds = self.get_param("muDS")
        log_mean_asd = self.get_param("muASD")
        log_mean_asa = self.get_param("muASA")
        log_mean_sf = np.zeros([batch_size, num_bs, num_ut],
                               self.np_rdtype)
        log_mean_k = self.get_param("muK") / 10.0
        log_mean_zsa = self.get_param("muZSA")
        # Table 7.5-7/7.5-8 ZSD log-mean
        log_mean_zsd_los = np.maximum(
            -0.5, -2.1 * (distance_2d / 1000.0)
            - 0.01 * np.abs(h_ut - 1.5) + 0.75)
        log_mean_zsd_nlos = np.maximum(
            -0.5, -2.1 * (distance_2d / 1000.0)
            - 0.01 * np.abs(h_ut - 1.5) + 0.9)
        log_mean_zsd = np.where(self.los, log_mean_zsd_los,
                                log_mean_zsd_nlos)

        self._lsp_log_mean = np.stack(
            [log_mean_ds, log_mean_asd, log_mean_asa, log_mean_sf,
             log_mean_k, log_mean_zsa, log_mean_zsd],
            axis=3).astype(self.np_rdtype)

        self._lsp_log_std = np.stack(
            [self.get_param("sigmaDS"), self.get_param("sigmaASD"),
             self.get_param("sigmaASA"), self.get_param("sigmaSF") / 10.,
             self.get_param("sigmaK") / 10., self.get_param("sigmaZSA"),
             self.get_param("sigmaZSD")], axis=3).astype(self.np_rdtype)

        # ZOD offset (Table 7.5-7)
        fc = max(self._carrier_frequency / 1e9, 6.)
        a = 0.208 * _log10(fc) - 0.782
        b = 25.
        c = -0.13 * _log10(fc) + 2.03
        e = 7.66 * _log10(fc) - 5.96
        zod_offset = (e - 10. ** (a * _log10(np.maximum(b, distance_2d))
                                  + c - 0.07 * (h_ut - 1.5)))
        self._zod_offset = np.where(self.los, 0., zod_offset
                                    ).astype(self.np_rdtype)

    def _compute_pathloss_basic(self):
        batch_size, num_bs, num_ut = (self.batch_size, self.num_bs,
                                      self.num_ut)
        distance_2d = self.distance_2d
        distance_3d = self.distance_3d
        fc = self._carrier_frequency  # Hz
        h_bs = self.h_bs[:, :, None]
        h_ut = self.h_ut[:, None, :]

        # Effective environment height (Note 1, Table 7.4.1-1)
        g = ((5. / 4.) * (distance_2d / 100.) ** 3.
             * np.exp(-distance_2d / 150.0))
        g = np.where(distance_2d < 18., 0.0, g)
        c = g * (np.maximum(h_ut - 13., 0.) / 10.) ** 1.5
        p = 1. / (1. + c)
        r = config.np_rng.uniform(size=[batch_size, num_bs, num_ut])
        r = np.where(r < p, 1.0, 0.0)
        max_value = np.broadcast_to(h_ut - 1.5,
                                    (batch_size, num_bs, num_ut))
        s = config.np_rng.uniform(size=[batch_size, num_bs, num_ut]) \
            * (max_value - 12.) + 12.
        s = np.where(s < 12.0, 12.0, s)
        h_e = r + (1. - r) * s
        h_bs_prime = h_bs - h_e
        h_ut_prime = h_ut - h_e
        d_bp = 4 * h_bs_prime * h_ut_prime * fc / SPEED_OF_LIGHT

        pl_1 = 28.0 + 22.0 * _log10(distance_3d) + 20.0 * _log10(fc / 1e9)
        pl_2 = (28.0 + 40.0 * _log10(distance_3d)
                + 20.0 * _log10(fc / 1e9)
                - 9.0 * _log10(d_bp ** 2 + (h_bs - h_ut) ** 2))
        pl_los = np.where(distance_2d < d_bp, pl_1, pl_2)

        pl_3 = (13.54 + 39.08 * _log10(distance_3d)
                + 20.0 * _log10(fc / 1e9) - 0.6 * (h_ut - 1.5))
        pl_nlos = np.maximum(pl_los, pl_3)

        self._pl_b = np.where(self.los, pl_los, pl_nlos
                              ).astype(self.np_rdtype)


class UMiScenario(SystemLevelScenario):
    """3GPP TR 38.901 urban microcell street-canyon (UMi) scenario."""

    def clip_carrier_frequency_lsp(self, fc):
        return max(fc, 2.)

    @property
    def min_2d_in(self):
        return 0.0

    @property
    def max_2d_in(self):
        return 25.0

    @property
    def los_probability(self):
        d_out = self._distance_2d_out
        with np.errstate(divide="ignore", invalid="ignore"):
            p = (18. / d_out
                 + np.exp(-d_out / 36.0) * (1. - 18. / d_out))
        return np.where(d_out < 18.0, 1.0, p)

    @property
    def rays_per_cluster(self):
        return 20

    @property
    def los_parameter_filepath(self):
        return "UMi_LoS.json"

    @property
    def nlos_parameter_filepath(self):
        return "UMi_NLoS.json"

    @property
    def o2i_parameter_filepath(self):
        return "UMi_O2I.json"

    def _compute_lsp_log_mean_std(self):
        batch_size, num_bs, num_ut = (self.batch_size, self.num_bs,
                                      self.num_ut)
        distance_2d = self.distance_2d
        h_bs = self.h_bs[:, :, None]
        h_ut = self.h_ut[:, None, :]

        log_mean_sf = np.zeros([batch_size, num_bs, num_ut],
                               self.np_rdtype)
        log_mean_zsd_los = np.maximum(
            -0.21, -14.8 * (distance_2d / 1000.0)
            + 0.01 * np.abs(h_ut - h_bs) + 0.83)
        log_mean_zsd_nlos = np.maximum(
            -0.5, -3.1 * (distance_2d / 1000.0)
            + 0.01 * np.maximum(h_ut - h_bs, 0.0) + 0.2)
        log_mean_zsd = np.where(self.los, log_mean_zsd_los,
                                log_mean_zsd_nlos)

        self._lsp_log_mean = np.stack(
            [self.get_param("muDS"), self.get_param("muASD"),
             self.get_param("muASA"), log_mean_sf,
             self.get_param("muK") / 10., self.get_param("muZSA"),
             log_mean_zsd], axis=3).astype(self.np_rdtype)

        self._lsp_log_std = np.stack(
            [self.get_param("sigmaDS"), self.get_param("sigmaASD"),
             self.get_param("sigmaASA"), self.get_param("sigmaSF") / 10.,
             self.get_param("sigmaK") / 10., self.get_param("sigmaZSA"),
             self.get_param("sigmaZSD")], axis=3).astype(self.np_rdtype)

        zod_offset = -10. ** (-1.5 * _log10(np.maximum(10., distance_2d))
                              + 3.3)
        self._zod_offset = np.where(self.los, 0., zod_offset
                                    ).astype(self.np_rdtype)

    def _compute_pathloss_basic(self):
        distance_2d = self.distance_2d
        distance_3d = self.distance_3d
        fc = self._carrier_frequency  # Hz
        h_bs = self.h_bs[:, :, None]
        h_ut = self.h_ut[:, None, :]

        h_e = 1.0
        d_bp = 4 * (h_bs - h_e) * (h_ut - h_e) * fc / SPEED_OF_LIGHT

        pl_1 = 32.4 + 21.0 * _log10(distance_3d) + 20.0 * _log10(fc / 1e9)
        pl_2 = (32.4 + 40.0 * _log10(distance_3d)
                + 20.0 * _log10(fc / 1e9)
                - 9.5 * _log10(d_bp ** 2 + (h_bs - h_ut) ** 2))
        pl_los = np.where(distance_2d < d_bp, pl_1, pl_2)

        pl_3 = (35.3 * _log10(distance_3d) + 22.4
                + 21.3 * _log10(fc / 1e9) - 0.3 * (h_ut - 1.5))
        pl_nlos = np.maximum(pl_los, pl_3)

        self._pl_b = np.where(self.los, pl_los, pl_nlos
                              ).astype(self.np_rdtype)


class RMaScenario(SystemLevelScenario):
    """3GPP TR 38.901 rural macrocell (RMa) scenario."""

    def __init__(self, carrier_frequency, ut_array, bs_array, direction,
                 enable_pathloss=True, enable_shadow_fading=True,
                 average_street_width=20.0, average_building_height=5.0,
                 precision=None, device=None):
        # Only the low-loss O2I model is available for RMa
        super().__init__(carrier_frequency, "low", ut_array, bs_array,
                         direction, enable_pathloss,
                         enable_shadow_fading, precision=precision,
                         device=device)
        self._average_street_width = float(average_street_width)
        self._average_building_height = float(average_building_height)

    def clip_carrier_frequency_lsp(self, fc):
        return fc

    @property
    def min_2d_in(self):
        return 0.0

    @property
    def max_2d_in(self):
        return 10.0

    @property
    def average_street_width(self):
        return self._average_street_width

    @property
    def average_building_height(self):
        return self._average_building_height

    @property
    def los_probability(self):
        d_out = self._distance_2d_out
        p = np.exp(-(d_out - 10.0) / 1000.0)
        return np.where(d_out < 10.0, 1.0, p)

    @property
    def rays_per_cluster(self):
        return 20

    @property
    def los_parameter_filepath(self):
        return "RMa_LoS.json"

    @property
    def nlos_parameter_filepath(self):
        return "RMa_NLoS.json"

    @property
    def o2i_parameter_filepath(self):
        return "RMa_O2I.json"

    def _compute_lsp_log_mean_std(self):
        batch_size, num_bs, num_ut = (self.batch_size, self.num_bs,
                                      self.num_ut)
        distance_2d = self.distance_2d
        h_bs = self.h_bs[:, :, None]
        h_ut = self.h_ut[:, None, :]

        log_mean_sf = np.zeros([batch_size, num_bs, num_ut],
                               self.np_rdtype)
        log_mean_zsd = (self.get_param("muZSDa") * (distance_2d / 1000.)
                        - 0.01 * (h_ut - 1.5)
                        + self.get_param("muZSDb"))
        log_mean_zsd = np.maximum(-1.0, log_mean_zsd)

        self._lsp_log_mean = np.stack(
            [self.get_param("muDS"), self.get_param("muASD"),
             self.get_param("muASA"), log_mean_sf,
             self.get_param("muK") / 10., self.get_param("muZSA"),
             log_mean_zsd], axis=3).astype(self.np_rdtype)

        # LoS SF std switches at the breakpoint distance
        d_bp = (2. * PI * h_bs * h_ut * self._carrier_frequency
                / SPEED_OF_LIGHT)
        log_std_sf_los = np.where(distance_2d < d_bp,
                                  self.get_param("sigmaSF1") / 10.0,
                                  self.get_param("sigmaSF2") / 10.0)
        log_std_sf = np.where(self.los, log_std_sf_los,
                              self.get_param("sigmaSF") / 10.0)

        self._lsp_log_std = np.stack(
            [self.get_param("sigmaDS"), self.get_param("sigmaASD"),
             self.get_param("sigmaASA"), log_std_sf,
             self.get_param("sigmaK") / 10., self.get_param("sigmaZSA"),
             self.get_param("sigmaZSD")], axis=3).astype(self.np_rdtype)

        zod_offset = (np.arctan((35. - 3.5) / distance_2d)
                      - np.arctan((35. - 1.5) / distance_2d))
        self._zod_offset = np.where(self.los, 0.0, zod_offset
                                    ).astype(self.np_rdtype)

    def _compute_pathloss_basic(self):
        distance_2d = self.distance_2d
        distance_3d = self.distance_3d
        fc = self._carrier_frequency / 1e9  # GHz
        h_bs = self.h_bs[:, :, None]
        h_ut = self.h_ut[:, None, :]
        h = self._average_building_height
        w = self._average_street_width

        d_bp = (2. * PI * h_bs * h_ut * self._carrier_frequency
                / SPEED_OF_LIGHT)

        pl_1 = (20.0 * _log10(40.0 * PI * distance_3d * fc / 3.)
                + min(0.03 * h ** 1.72, 10.0) * _log10(distance_3d)
                - min(0.044 * h ** 1.72, 14.77)
                + 0.002 * _log10(h) * distance_3d)
        pl_2 = (20.0 * _log10(40.0 * PI * d_bp * fc / 3.)
                + min(0.03 * h ** 1.72, 10.0) * _log10(d_bp)
                - min(0.044 * h ** 1.72, 14.77)
                + 0.002 * _log10(h) * d_bp
                + 40.0 * _log10(distance_3d / d_bp))
        pl_los = np.where(distance_2d < d_bp, pl_1, pl_2)

        pl_3 = (161.04 - 7.1 * _log10(w) + 7.5 * _log10(h)
                - (24.37 - 3.7 * (h / h_bs) ** 2) * _log10(h_bs)
                + (43.42 - 3.1 * _log10(h_bs))
                * (_log10(distance_3d) - 3.0)
                + 20.0 * _log10(fc)
                - (3.2 * _log10(11.75 * h_ut) ** 2 - 4.97))
        pl_nlos = np.maximum(pl_los, pl_3)

        self._pl_b = np.where(self.los, pl_los, pl_nlos
                              ).astype(self.np_rdtype)
