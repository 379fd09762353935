"""TR 38.901 clustered delay line (CDL) models A-E (counterpart of
``sionna_tpu/phy/channel/tr38901/cdl.py``).

The model tables are read from the JAX package's JSON files, by path.
``__call__`` makes every random draw (velocities, the random coupling of
the ray angles, the ray phases) from one ``torch.Generator`` and hands
them to ``cir``, which computes the CIR deterministically. The model
has no trainable parameters.
"""

import json
from pathlib import Path

import numpy as np
import torch

from ...config import config
from ...constants import PI
from ..channel_model import ChannelModel
from .rays import Rays
from .channel_coefficients import Topology, ChannelCoefficientsGenerator

__all__ = ["CDL"]

_MODELS_DIR = (Path(__file__).resolve().parents[4] / "sionna_tpu" / "phy"
               / "channel" / "tr38901" / "models")

# TR 38.901 Table 7.5-3: ray offset angles within a cluster
_RAY_OFFSETS = np.array([0.0447, -0.0447, 0.1413, -0.1413, 0.2492,
                         -0.2492, 0.3715, -0.3715, 0.5129, -0.5129,
                         0.6797, -0.6797, 0.8844, -0.8844, 1.1481,
                         -1.1481, 1.5195, -1.5195, 2.1551, -2.1551])


class CDL(ChannelModel):
    """Clustered delay line channel model (one TX, one RX, both possibly
    with several antennas).

    Call with ``(batch_size, num_time_steps, sampling_frequency)`` and
    optionally ``generator=`` (the draws then happen on its device) or
    ``device=`` (default: the ``device`` given here, else
    ``config.device``). Returns ``(a [batch, 1, rx_ant, 1, tx_ant,
    clusters, time], tau [batch, 1, 1, clusters])``.
    """

    NUM_RAYS = 20

    def __init__(self, model, delay_spread, carrier_frequency, ut_array,
                 bs_array, direction, ut_orientation=None,
                 bs_orientation=None, min_speed=0., max_speed=None,
                 precision=None, device=None):
        super().__init__(precision=precision)
        if direction not in ("uplink", "downlink"):
            raise ValueError("Invalid link direction")
        self._direction = direction
        if ut_orientation is None:
            ut_orientation = np.array([PI, 0.0, 0.0])
        if bs_orientation is None:
            bs_orientation = np.zeros(3)
        if direction == "downlink":
            self._moving_end = "rx"
            self._tx_array, self._rx_array = bs_array, ut_array
            self._tx_orientation = np.asarray(bs_orientation, float)
            self._rx_orientation = np.asarray(ut_orientation, float)
        else:
            self._moving_end = "tx"
            self._tx_array, self._rx_array = ut_array, bs_array
            self._tx_orientation = np.asarray(ut_orientation, float)
            self._rx_orientation = np.asarray(bs_orientation, float)

        self._device = config.device if device is None \
            else torch.device(device)
        self._carrier_frequency = float(carrier_frequency)
        self._delay_spread = float(delay_spread)
        self._min_speed = float(min_speed)
        self._max_speed = self._min_speed if max_speed is None \
            else float(max_speed)
        if self._max_speed < self._min_speed:
            raise ValueError("min_speed cannot be larger than max_speed")

        if model not in ("A", "B", "C", "D", "E"):
            raise ValueError("Invalid CDL model")
        self._load_parameters(f"CDL-{model}.json")

        self._cir_sampler = ChannelCoefficientsGenerator(
            carrier_frequency, self._tx_array, self._rx_array,
            subclustering=False, precision=precision)
        self._tables = {}

    # ------------------------------------------------------------------
    @property
    def num_clusters(self):
        return self._num_clusters

    @property
    def los(self):
        return self._los

    @property
    def k_factor(self):
        """K-factor (linear) of the zero-delay path: specular over
        diffuse power of path 0."""
        if not self._los:
            return None
        return self._k_factor[0, 0, 0] / self._powers[0, 0, 0, 0]

    @property
    def delays(self):
        return self._delays[0, 0, 0] * self._delay_spread

    @property
    def powers(self):
        """Path powers in linear scale; for LoS models path 0 combines
        the specular and diffuse power and the total is renormalized by
        K+1."""
        p = np.asarray(self._powers[0, 0, 0])
        if self._los:
            k = np.asarray(self._k_factor[0, 0, 0])
            p = p.copy()
            p[0] = p[0] + k
            p = p / (k + 1.)
        return p

    @property
    def delay_spread(self):
        return self._delay_spread

    @delay_spread.setter
    def delay_spread(self, value):
        self._delay_spread = float(value)

    def numpy_structure(self):
        """The model's tables (normalised delays, cluster powers, ray
        angles as arrival/departure at this link's ends, XPR, the
        K-factor, the LoS angles) and both arrays' element positions,
        for :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        out = {"delays": self._delays, "powers": self._powers,
               "aoa": self._aoa, "aod": self._aod, "zoa": self._zoa,
               "zod": self._zod, "xpr": self._xpr,
               "k_factor": self._k_factor}
        if self._los:
            out.update(los_aoa=self._los_aoa, los_aod=self._los_aod,
                       los_zoa=self._los_zoa, los_zod=self._los_zod)
        for end, array in (("tx_array", self._tx_array),
                           ("rx_array", self._rx_array)):
            out.update({f"{end}.{k}": v
                        for k, v in array.numpy_structure().items()})
        return out

    # ------------------------------------------------------------------
    def __call__(self, batch_size, num_time_steps, sampling_frequency,
                 generator=None, device=None):
        if generator is not None:
            dev = generator.device
        else:
            dev = self._device if device is None else torch.device(device)
            generator = config.generator(dev)
        rdtype = self.rdtype
        shape = (batch_size, 1, 1, self._num_clusters, CDL.NUM_RAYS)

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, dtype=rdtype,
                           device=dev)
            return u * (hi - lo) + lo

        # random velocity vectors: speed, azimuth and zenith [batch, 1]
        v_r = uniform((batch_size, 1), self._min_speed, self._max_speed)
        v_phi = uniform((batch_size, 1), 0., 2. * PI)
        v_theta = uniform((batch_size, 1), 0., PI)
        # random coupling of the rays within each cluster (step 8): one
        # permutation per angle, the ranks of normal draws
        perms = [torch.argsort(torch.randn(shape, generator=generator,
                                           dtype=rdtype, device=dev),
                               dim=-1, stable=True) for _ in range(4)]
        # random initial phases (step 10)
        phi = uniform(shape + (4,), -PI, PI)
        return self.cir(num_time_steps, sampling_frequency, v_r, v_phi,
                        v_theta, perms, phi)

    def cir(self, num_time_steps, sampling_frequency, v_r, v_phi, v_theta,
            perms, phi):
        """The CIR of given draws: speeds, azimuths and zeniths of the
        velocities [batch, 1]; the permutations of the rays of each
        cluster for aoa, aod, zoa and zod [batch, 1, 1, clusters, rays];
        the ray phases [batch, 1, 1, clusters, rays, 4]. Returns what
        ``__call__`` does."""
        rdtype = self.rdtype
        dev = phi.device
        batch_size = phi.shape[0]
        velocities = torch.stack(
            [v_r * torch.cos(v_phi) * torch.sin(v_theta),
             v_r * torch.sin(v_phi) * torch.sin(v_theta),
             v_r * torch.cos(v_theta)], dim=-1)

        tables = self._device_tables(dev)

        def table(name):
            """A [1, ...] table as [batch, ...] on the device."""
            t = tables[name]
            return t.expand((batch_size,) + t.shape[1:])

        topology = Topology(
            velocities=velocities, moving_end=self._moving_end,
            los_aoa=table("los_aoa"), los_zoa=table("los_zoa"),
            los_aod=table("los_aod"), los_zod=table("los_zod"),
            los=self._los,
            distance_3d=torch.zeros([batch_size, 1, 1], dtype=rdtype,
                                    device=dev),
            tx_orientations=table("tx_orientation"),
            rx_orientations=table("rx_orientation"))

        def coupled(name, perm):
            return torch.gather(table(name), -1, perm)

        rays = Rays(delays=table("delays"),
                    powers=table("powers"),
                    aoa=coupled("aoa", perms[0]),
                    aod=coupled("aod", perms[1]),
                    zoa=coupled("zoa", perms[2]),
                    zod=coupled("zod", perms[3]),
                    xpr=table("xpr"))
        t = self._cir_sampler.sample_times(num_time_steps,
                                           sampling_frequency, dev)
        h, delays = self._cir_sampler._step_11(
            phi, topology, table("k_factor"), rays, t, None)
        # [b, tx, rx, cl, rxa, txa, T] -> [b, rx, rxa, tx, txa, cl, T]
        h = h.permute(0, 2, 4, 1, 5, 3, 6)
        delays = delays.permute(0, 2, 1, 3)
        return h.contiguous(), delays.contiguous()

    def _device_tables(self, device):
        """The model's tables as [1, ...] tensors in the real dtype on
        ``device`` (the delays scaled by the delay spread), made once per
        device and delay spread, so that a call copies nothing from the
        host."""
        key = (device, self._delay_spread)
        if key not in self._tables:
            host = {"delays": self._delays * self._delay_spread,
                    "tx_orientation": self._tx_orientation[None, None],
                    "rx_orientation": self._rx_orientation[None, None]}
            for name in ("powers", "aoa", "aod", "zoa", "zod", "xpr",
                         "k_factor", "los_aoa", "los_aod", "los_zoa",
                         "los_zod"):
                host[name] = getattr(self, "_" + name)
            self._tables = {key: {
                name: torch.as_tensor(np.asarray(x), device=device).to(
                    self.rdtype) for name, x in host.items()}}
        return self._tables[key]

    # ------------------------------------------------------------------
    def _load_parameters(self, fname):
        with open(_MODELS_DIR / fname) as f:
            params = json.load(f)
        self._los = bool(params["los"])
        self._num_clusters = int(params["num_clusters"])
        delays = np.asarray(params["delays"], np.float64)
        powers = np.power(10.0, np.asarray(params["powers"],
                                           np.float64) / 10.0)
        powers = powers / powers.sum()
        c_aod = float(params["cASD"])
        c_aoa = float(params["cASA"])
        c_zod = float(params["cZSD"])
        c_zoa = float(params["cZSA"])
        aod = np.asarray(params["aod"], np.float64)
        aoa = np.asarray(params["aoa"], np.float64)
        zod = np.asarray(params["zod"], np.float64)
        zoa = np.asarray(params["zoa"], np.float64)

        if self._los:
            los_power = powers[0]
            powers, delays = powers[1:], delays[1:]
            los_aod, aod = aod[0], aod[1:]
            los_aoa, aoa = aoa[0], aoa[1:]
            los_zod, zod = zod[0], zod[1:]
            los_zoa, zoa = zoa[0], zoa[1:]
            norm_fact = powers.sum()
            powers = powers / norm_fact
            k_factor = los_power / norm_fact
            los_aod = np.deg2rad(los_aod)
            los_aoa = np.deg2rad(los_aoa)
            los_zod = np.deg2rad(los_zod)
            los_zoa = np.deg2rad(los_zoa)
        else:
            k_factor = 1.0
            los_aod = los_aoa = los_zod = los_zoa = 0.0

        def rays_from(angles, c):
            # (7.7-0a): cluster angle + spread * fixed offsets
            return np.deg2rad(angles[:, None] + c * _RAY_OFFSETS[None, :])

        aod = rays_from(aod, c_aod)
        aoa = rays_from(aoa, c_aoa)
        zod = rays_from(zod, c_zod)
        zoa = rays_from(zoa, c_zoa)

        def r3(x):
            return np.asarray(x)[None, None, None]

        self._k_factor = r3(k_factor)
        self._delays = r3(delays)
        self._powers = r3(powers)
        if self._direction == "downlink":
            self._los_aoa, self._los_zoa = r3(los_aoa), r3(los_zoa)
            self._los_aod, self._los_zod = r3(los_aod), r3(los_zod)
            self._aoa, self._zoa = r3(aoa), r3(zoa)
            self._aod, self._zod = r3(aod), r3(zod)
        else:  # uplink: swap departure and arrival
            self._los_aoa, self._los_zoa = r3(los_aod), r3(los_zod)
            self._los_aod, self._los_zod = r3(los_aoa), r3(los_zoa)
            self._aoa, self._zoa = r3(aod), r3(zod)
            self._aod, self._zod = r3(aoa), r3(zoa)

        # for LoS models num_clusters already excludes the specular entry
        xpr = np.power(10.0, float(params["xpr"]) / 10.0)
        self._xpr = r3(np.full([self._num_clusters, CDL.NUM_RAYS], xpr))
