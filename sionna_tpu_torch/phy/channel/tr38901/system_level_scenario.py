"""System-level TR 38.901 scenario base class (counterpart of
``sionna_tpu/phy/channel/tr38901/system_level_scenario.py``).

The topology state (distances, LoS and indoor states, LSP log-moments,
basic pathloss) is computed on the host in NumPy by :meth:`set_topology`,
with the JAX package's code, dtypes and ``config.np_rng`` draws: one
seed gives both packages the same state. The samplers read it on the
device through :meth:`tensor` and :meth:`param_tensor`, which copy each
array there once per topology.
"""

import json
from abc import abstractmethod
from pathlib import Path

import numpy as np
import torch

from ...block import Object
from ...config import config
from ...constants import PI, SPEED_OF_LIGHT
from .antenna import PanelArray

_MODELS_DIR = (Path(__file__).resolve().parents[4] / "sionna_tpu" / "phy"
               / "channel" / "tr38901" / "models")

__all__ = ["SystemLevelScenario"]


def _np_log10(x):
    return np.log10(x)


class SystemLevelScenario(Object):
    """Base class defining a system-level simulation scenario (UMi,
    UMa, RMa).

    ``device`` (default ``config.device``) is where :meth:`tensor` and
    :meth:`param_tensor` put the topology state that the samplers read:
    each array is copied there once per topology."""

    def __init__(self, carrier_frequency, o2i_model, ut_array, bs_array,
                 direction, enable_pathloss=True,
                 enable_shadow_fading=True, precision=None, device=None):
        super().__init__(precision=precision)
        self._device = config.device if device is None \
            else torch.device(device)
        self._tensors = {}

        self._carrier_frequency = float(carrier_frequency)
        self._lambda_0 = SPEED_OF_LIGHT / float(carrier_frequency)

        if o2i_model not in ("low", "high"):
            raise ValueError("o2i_model must be 'low' or 'high'")
        self._o2i_model = o2i_model

        if not isinstance(ut_array, PanelArray):
            raise TypeError("'ut_array' must be an instance of PanelArray")
        if not isinstance(bs_array, PanelArray):
            raise TypeError("'bs_array' must be an instance of PanelArray")
        self._ut_array = ut_array
        self._bs_array = bs_array

        if direction not in ("uplink", "downlink"):
            raise ValueError("'direction' must be 'uplink' or 'downlink'")
        self._direction = direction

        self._enable_pathloss = bool(enable_pathloss)
        self._enable_shadow_fading = bool(enable_shadow_fading)

        self._ut_loc = None
        self._bs_loc = None
        self._bs_virtual_loc = None
        self._ut_orientations = None
        self._bs_orientations = None
        self._ut_velocities = None
        self._in_state = None
        self._requested_los = None

        self._load_params()

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    @property
    def device(self):
        """torch.device : Where the topology state goes for sampling"""
        return self._device

    def tensor(self, name):
        """The NumPy attribute ``name`` of the topology state (e.g.
        ``"los"``, ``"lsp_log_mean"``) as a tensor on :attr:`device`,
        copied once per topology."""
        key = ("attr", name)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(
                np.ascontiguousarray(getattr(self, name)),
                device=self._device)
        return self._tensors[key]

    def param_tensor(self, parameter_name):
        """:meth:`get_param` as a tensor on :attr:`device`, copied once
        per topology."""
        key = ("param", parameter_name)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(
                self.get_param(parameter_name), device=self._device)
        return self._tensors[key]

    @property
    def carrier_frequency(self):
        """Carrier frequency [Hz]"""
        return self._carrier_frequency

    @property
    def direction(self):
        return self._direction

    @property
    def pathloss_enabled(self):
        return self._enable_pathloss

    @property
    def shadow_fading_enabled(self):
        return self._enable_shadow_fading

    @property
    def lambda_0(self):
        """Wavelength [m]"""
        return self._lambda_0

    @property
    def batch_size(self):
        return int(self._ut_loc.shape[0])

    @property
    def num_ut(self):
        return int(self._ut_loc.shape[1])

    @property
    def num_bs(self):
        return int(self._bs_loc.shape[1])

    @property
    def h_ut(self):
        """[batch, num_ut] UT heights [m]"""
        return self._ut_loc[:, :, 2]

    @property
    def h_bs(self):
        """[batch, num_bs] BS heights [m]"""
        return self._bs_loc[:, :, 2]

    @property
    def ut_loc(self):
        return self._ut_loc

    @property
    def bs_loc(self):
        return self._bs_loc

    @property
    def bs_virtual_loc(self):
        """Virtual BS locations relative to each UT (wraparound);
        broadcastable to [batch, num_bs, num_ut, 3]."""
        return self._bs_virtual_loc

    @property
    def ut_orientations(self):
        return self._ut_orientations

    @property
    def bs_orientations(self):
        return self._bs_orientations

    @property
    def ut_velocities(self):
        return self._ut_velocities

    @property
    def ut_array(self):
        return self._ut_array

    @property
    def bs_array(self):
        return self._bs_array

    @property
    def indoor(self):
        """[batch, num_ut] bool indoor state"""
        return self._in_state

    @property
    def los(self):
        """[batch, num_bs, num_ut] bool LoS state"""
        return self._los

    @property
    def distance_2d(self):
        return self._distance_2d

    @property
    def distance_2d_in(self):
        return self._distance_2d_in

    @property
    def distance_2d_out(self):
        return self._distance_2d_out

    @property
    def distance_3d(self):
        return self._distance_3d

    @property
    def distance_3d_in(self):
        return self._distance_3d_in

    @property
    def distance_3d_out(self):
        return self._distance_3d_out

    @property
    def matrix_ut_distance_2d(self):
        """[batch, num_ut, num_ut] pairwise UT 2D distances [m]"""
        return self._matrix_ut_distance_2d

    @property
    def los_aod(self):
        """[batch, num_bs, num_ut] LoS AoD [deg]"""
        return self._los_aod

    @property
    def los_aoa(self):
        return self._los_aoa

    @property
    def los_zod(self):
        return self._los_zod

    @property
    def los_zoa(self):
        return self._los_zoa

    @property
    @abstractmethod
    def los_probability(self):
        """[batch, num_bs, num_ut] LoS probability (7.4.2)"""

    @property
    @abstractmethod
    def min_2d_in(self):
        """Minimum indoor 2D distance for indoor UTs [m]"""

    @property
    @abstractmethod
    def max_2d_in(self):
        """Maximum indoor 2D distance for indoor UTs [m]"""

    @property
    def lsp_log_mean(self):
        """[batch, num_bs, num_ut, 7] log-domain LSP means, ordered
        DS - ASD - ASA - SF - K - ZSA - ZSD"""
        return self._lsp_log_mean

    @property
    def lsp_log_std(self):
        return self._lsp_log_std

    @property
    @abstractmethod
    def rays_per_cluster(self):
        """Number of rays per cluster"""

    @property
    def zod_offset(self):
        return self._zod_offset

    @property
    def num_clusters_los(self):
        return int(self._params_los["numClusters"])

    @property
    def num_clusters_nlos(self):
        return int(self._params_nlos["numClusters"])

    @property
    def num_clusters_indoor(self):
        return int(self._params_o2i["numClusters"])

    @property
    def num_clusters_max(self):
        return max(self.num_clusters_los, self.num_clusters_nlos,
                   self.num_clusters_indoor)

    @property
    def basic_pathloss(self):
        """[batch, num_bs, num_ut] basic pathloss [dB] (7.4.1)"""
        return self._pl_b

    @property
    def o2i_model(self):
        return self._o2i_model

    # ------------------------------------------------------------------
    # Topology
    # ------------------------------------------------------------------
    def set_topology(self, ut_loc=None, bs_loc=None, ut_orientations=None,
                     bs_orientations=None, ut_velocities=None,
                     in_state=None, los=None, bs_virtual_loc=None):
        """Sets the network topology. All arguments are converted to
        host NumPy arrays (tensors are read back); returns whether an
        update was required."""

        def _np(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return None if x is None else np.asarray(x)

        ut_loc = _np(ut_loc)
        bs_loc = _np(bs_loc)
        ut_orientations = _np(ut_orientations)
        bs_orientations = _np(bs_orientations)
        ut_velocities = _np(ut_velocities)
        in_state = _np(in_state)
        bs_virtual_loc = _np(bs_virtual_loc)

        assert ut_loc is not None or self._ut_loc is not None, \
            "`ut_loc` is None and was not previously set"
        assert bs_loc is not None or self._bs_loc is not None, \
            "`bs_loc` is None and was not previously set"
        assert (bs_virtual_loc is not None or bs_loc is not None
                or self._bs_virtual_loc is not None), \
            "`bs_virtual_loc` is None and was not previously set"
        assert in_state is not None or self._in_state is not None, \
            "`in_state` is None and was not previously set"
        assert (ut_orientations is not None
                or self._ut_orientations is not None), \
            "`ut_orientations` is None and was not previously set"
        assert (bs_orientations is not None
                or self._bs_orientations is not None), \
            "`bs_orientations` is None and was not previously set"
        assert (ut_velocities is not None
                or self._ut_velocities is not None), \
            "`ut_velocities` is None and was not previously set"

        need_for_update = False
        if ut_loc is not None:
            self._ut_loc = ut_loc.astype(self.np_rdtype)
            need_for_update = True
        if bs_loc is not None:
            self._bs_loc = bs_loc.astype(self.np_rdtype)
            need_for_update = True
        if bs_virtual_loc is not None:
            self._bs_virtual_loc = bs_virtual_loc.astype(self.np_rdtype)
            need_for_update = True
        elif bs_loc is not None:
            # [batch, num_bs, 1, 3]
            self._bs_virtual_loc = self._bs_loc[:, :, None, :]
        if bs_orientations is not None:
            self._bs_orientations = bs_orientations.astype(self.np_rdtype)
        if ut_orientations is not None:
            self._ut_orientations = ut_orientations.astype(self.np_rdtype)
        if ut_velocities is not None:
            self._ut_velocities = ut_velocities.astype(self.np_rdtype)
        if in_state is not None:
            self._in_state = in_state.astype(bool)
            need_for_update = True
        if los is not None:
            self._requested_los = bool(los)
            need_for_update = True

        if need_for_update:
            self._tensors = {}
            self._compute_distance_2d_3d_and_angles()
            self._sample_indoor_distance()
            self._sample_los()
            self._compute_lsp_log_mean_std()
            self._compute_pathloss_basic()

        return need_for_update

    def spatial_correlation_matrix(self, correlation_distance):
        """exp(-d/D) spatial correlation over UT pairs."""
        return np.exp(-self.matrix_ut_distance_2d
                      / float(correlation_distance))

    # ------------------------------------------------------------------
    # Parameter files
    # ------------------------------------------------------------------
    @property
    @abstractmethod
    def los_parameter_filepath(self):
        """Filename of the LoS parameter JSON"""

    @property
    @abstractmethod
    def nlos_parameter_filepath(self):
        """Filename of the NLoS parameter JSON"""

    @property
    @abstractmethod
    def o2i_parameter_filepath(self):
        """Filename of the O2I parameter JSON"""

    @abstractmethod
    def clip_carrier_frequency_lsp(self, fc):
        """Clip the carrier frequency [GHz] for LSP computation"""

    def get_param(self, parameter_name):
        """Per-link parameter [batch, num_bs, num_ut] resolved by each
        link's state (LoS/NLoS/O2I)."""
        fc = self._carrier_frequency / 1e9
        fc = self.clip_carrier_frequency_lsp(fc)

        if parameter_name in ("muDS", "sigmaDS", "muASD", "sigmaASD",
                              "muASA", "sigmaASA", "muZSA", "sigmaZSA"):
            value = {}
            for state, params in (("los", self._params_los),
                                  ("nlos", self._params_nlos),
                                  ("o2i", self._params_o2i)):
                pa = params[parameter_name + "a"]
                pb = params[parameter_name + "b"]
                pc = params[parameter_name + "c"]
                value[state] = pa * _np_log10(pb + fc) + pc
        elif parameter_name == "cDS":
            value = {}
            for state, params in (("los", self._params_los),
                                  ("nlos", self._params_nlos),
                                  ("o2i", self._params_o2i)):
                pa = params[parameter_name + "a"]
                pb = params[parameter_name + "b"]
                pc = params[parameter_name + "c"]
                value[state] = max(pa, pb - pc * _np_log10(fc))
        else:
            value = {"los": self._params_los[parameter_name],
                     "nlos": self._params_nlos[parameter_name],
                     "o2i": self._params_o2i[parameter_name]}

        indoor = self._in_state[:, None, :]  # [b, 1, nut]
        los = self._los
        nlos = ~los & ~indoor
        out = np.zeros((self.batch_size, self.num_bs, self.num_ut),
                       self.np_rdtype)
        out = np.where(los, self.np_rdtype(value["los"]), out)
        out = np.where(nlos, self.np_rdtype(value["nlos"]), out)
        out = np.where(indoor, self.np_rdtype(value["o2i"]), out)
        return out

    # ------------------------------------------------------------------
    # Internal utilities
    # ------------------------------------------------------------------
    def _compute_distance_2d_3d_and_angles(self):
        """2D/3D BS-UT distances, UT-UT distances, and LoS angles."""
        ut_loc = self._ut_loc[:, None, :, :]        # [b, 1, nut, 3]
        bs_virtual_loc = self._bs_virtual_loc       # [b, nbs, {1,nut}, 3]

        delta_loc = ut_loc - bs_virtual_loc
        delta_loc_xy = delta_loc[..., :2]

        distance_2d = np.sqrt(np.sum(delta_loc_xy ** 2, axis=3))
        distance_2d = np.broadcast_to(
            distance_2d, (self.batch_size, self.num_bs, self.num_ut)
        ).astype(self.np_rdtype)
        self._distance_2d = distance_2d

        distance_3d = np.sqrt(np.sum(delta_loc ** 2, axis=3))
        distance_3d = np.broadcast_to(
            distance_3d, (self.batch_size, self.num_bs, self.num_ut)
        ).astype(self.np_rdtype)
        self._distance_3d = distance_3d

        los_aod = np.arctan2(delta_loc[..., 1], delta_loc[..., 0])
        los_aoa = los_aod + PI
        los_zod = np.arctan2(distance_2d, delta_loc[..., 2])
        los_zoa = los_zod - PI

        def _deg(x):
            x = np.broadcast_to(
                np.mod(x * 180.0 / PI, 360.0),
                (self.batch_size, self.num_bs, self.num_ut))
            return x.astype(self.np_rdtype)

        self._los_aod = _deg(los_aod)
        self._los_aoa = _deg(los_aoa)
        self._los_zod = _deg(los_zod)
        self._los_zoa = _deg(los_zoa)

        ut_loc_xy = self._ut_loc[:, :, :2]
        delta = ut_loc_xy[:, None, :, :] - ut_loc_xy[:, :, None, :]
        self._matrix_ut_distance_2d = np.sqrt(
            np.sum(delta ** 2, axis=3)).astype(self.np_rdtype)

    def _sample_los(self):
        """Bernoulli LoS states per link (7.4.2)."""
        if self._requested_los is None:
            p = self.los_probability
            u = config.np_rng.uniform(
                size=(self.batch_size, self.num_bs, self.num_ut))
            los = u < p
        else:
            los = np.full(
                (self.batch_size, self.num_bs, self.num_ut),
                self._requested_los, bool)
        self._los = los & ~self._in_state[:, None, :]

    def _sample_indoor_distance(self):
        """Indoor 2D distances (7.4.3.1)."""
        indoor_mask = self._in_state[:, None, :].astype(self.np_rdtype)
        self._distance_2d_in = config.np_rng.uniform(
            low=float(self.min_2d_in), high=float(self.max_2d_in),
            size=(self.batch_size, self.num_bs, self.num_ut)
        ).astype(self.np_rdtype) * indoor_mask
        self._distance_2d_out = self._distance_2d - self._distance_2d_in
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(self._distance_2d > 0.,
                            self._distance_2d_in / self._distance_2d, 0.)
        self._distance_3d_in = (frac * self._distance_3d
                                ).astype(self.np_rdtype)
        self._distance_3d_out = self._distance_3d - self._distance_3d_in

    def _load_params(self):
        """Loads the LoS/NLoS/O2I parameter JSONs."""
        def _load(name):
            with open(_MODELS_DIR / name, encoding="utf-8") as f:
                return json.load(f)
        self._params_o2i = _load(self.o2i_parameter_filepath)
        self._params_los = _load(self.los_parameter_filepath)
        self._params_nlos = _load(self.nlos_parameter_filepath)

    @abstractmethod
    def _compute_lsp_log_mean_std(self):
        """Computes mean/std of LSPs in log domain"""

    @abstractmethod
    def _compute_pathloss_basic(self):
        """Computes the basic pathloss component [dB]"""
