"""3GPP TR 38.901 tapped delay line (TDL) models A-E / A30/B100/C300
(counterpart of ``sionna_tpu/phy/channel/tr38901/tdl.py``).

Doppler follows the sum-of-sinusoids method (20 sinusoids by default).
The phases are computed directly for every time step over
[batch, rx_ant, tx_ant, clusters, time, sinusoids]; the JAX package's
batch-minor layout and incremental phasor rotation are TPU layout work
and give the same statistics. The model tables are read from the JAX
package's JSON files, by path.
"""

import json
from pathlib import Path

import numpy as np
import torch

from ...config import config
from ...constants import PI, SPEED_OF_LIGHT
from ..channel_model import ChannelModel

_MODELS_DIR = (Path(__file__).resolve().parents[4] / "sionna_tpu" / "phy"
               / "channel" / "tr38901" / "models")


class TDL(ChannelModel):
    """Tapped-delay-line channel model per TR 38.901.

    Call with ``(batch_size, num_time_steps, sampling_frequency)`` and
    optionally ``generator=`` (the draws then happen on its device) or
    ``device=`` (default: the ``device`` given here, else
    ``config.device``).
    """

    def __init__(self, model, delay_spread, carrier_frequency,
                 num_sinusoids=20, los_angle_of_arrival=PI / 4.,
                 min_speed=0., max_speed=None, num_rx_ant=1, num_tx_ant=1,
                 spatial_corr_mat=None, rx_corr_mat=None, tx_corr_mat=None,
                 precision=None, device=None):
        super().__init__(precision=precision)
        if model not in ("A", "B", "C", "D", "E", "A30", "B100", "C300"):
            raise ValueError("Invalid TDL model")
        if model in ("A30", "B100", "C300"):
            forced = {"A30": 30e-9, "B100": 100e-9, "C300": 300e-9}[model]
            if delay_spread != forced:
                print(f"Warning: Delay spread is set to "
                      f"{forced*1e9:.0f}ns with this model")
                delay_spread = forced
        self._load_parameters(f"TDL-{model}.json")

        self._device = config.device if device is None \
            else torch.device(device)
        self._num_rx_ant = int(num_rx_ant)
        self._num_tx_ant = int(num_tx_ant)
        self._carrier_frequency = float(carrier_frequency)
        self._num_sinusoids = int(num_sinusoids)
        self._los_angle_of_arrival = float(los_angle_of_arrival)
        self._delay_spread = float(delay_spread)
        self._min_speed = float(min_speed)
        self._max_speed = self._min_speed if max_speed is None \
            else float(max_speed)
        if self._max_speed < self._min_speed:
            raise ValueError("min_speed cannot be larger than max_speed")
        self._min_doppler = self._compute_doppler(self._min_speed)
        self._max_doppler = self._compute_doppler(self._max_speed)

        n = self._num_sinusoids
        self._alpha_const = ((2. * PI / n) * np.arange(1, n + 1)).astype(
            self.np_rdtype)

        def chol(m):
            return np.linalg.cholesky(np.asarray(m, self.np_cdtype))

        self._spatial_corr_mat_sqrt = None
        self._rx_corr_mat_sqrt = None
        self._tx_corr_mat_sqrt = None
        if spatial_corr_mat is not None:
            self._spatial_corr_mat_sqrt = chol(spatial_corr_mat)
        else:
            if rx_corr_mat is not None:
                self._rx_corr_mat_sqrt = chol(rx_corr_mat)
            if tx_corr_mat is not None:
                self._tx_corr_mat_sqrt = chol(tx_corr_mat)

    @property
    def num_clusters(self):
        return self._num_clusters

    @property
    def los(self):
        return self._los

    @property
    def k_factor(self):
        """Ratio of specular to diffuse power of the first path
        (LoS models only)."""
        if not self._los:
            return None
        return self._los_power / self._mean_powers[0]

    @property
    def delays(self):
        """Path delays [s]: scaled by the delay spread, or ns -> s for
        fixed-delay models."""
        if self._scale_delays:
            return self._delays * self._delay_spread
        return self._delays * 1e-9

    @property
    def mean_powers(self):
        """Path powers in linear scale; for LoS models the first tap
        combines the specular and diffuse power."""
        if self._los:
            return np.concatenate(
                [self._mean_powers[:1] + self._los_power,
                 self._mean_powers[1:]], axis=0)
        return self._mean_powers

    @property
    def mean_power_los(self):
        return self._los_power if self._los else None

    @property
    def delay_spread(self):
        return self._delay_spread

    @delay_spread.setter
    def delay_spread(self, value):
        if self._scale_delays:
            self._delay_spread = float(value)
        else:
            print("Warning: delay spread is fixed for this model")

    def numpy_structure(self):
        """The model's tables (normalised delays, diffuse cluster
        powers and, for LoS models, the specular power), for
        :func:`~sionna_tpu_torch.phy.utils.interop.load_numpy_state`."""
        out = {"delays": self._delays, "mean_powers": self._mean_powers}
        if self._los:
            out["los_power"] = np.asarray(self._los_power)
        return out

    def __call__(self, batch_size, num_time_steps, sampling_frequency,
                 generator=None, device=None):
        if generator is not None:
            dev = generator.device
        else:
            dev = self._device if device is None else torch.device(device)
            generator = config.generator(dev)
        rdtype = self.rdtype
        m, n = self._num_clusters, self._num_sinusoids
        nr, nt = self._num_rx_ant, self._num_tx_ant

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, dtype=rdtype,
                           device=dev)
            return u * (hi - lo) + lo

        sample_times = (torch.arange(num_time_steps, dtype=rdtype,
                                     device=dev) / sampling_frequency)
        doppler = uniform((batch_size,), self._min_doppler,
                          self._max_doppler)
        theta = uniform((batch_size, m, n), -PI / n, PI / n)
        alpha = torch.as_tensor(self._alpha_const, device=dev) + theta
        phi = uniform((batch_size, nr, nt, m, n), -PI, PI)

        # arg[b, i, j, c, t, s] = phi + doppler * t * cos(alpha)
        w = doppler[:, None, None] * torch.cos(alpha)  # [B, m, n]
        arg = (phi[:, :, :, :, None, :]
               + w[:, None, None, :, None, :]
               * sample_times[:, None])
        h = torch.complex(torch.cos(arg), torch.sin(arg)).sum(-1)
        scale = torch.sqrt(torch.as_tensor(self._mean_powers, dtype=rdtype,
                                           device=dev)) / np.sqrt(n)
        h = h * scale[:, None]  # [B, nr, nt, m, T]
        # -> [B, 1, nr, 1, nt, m, T] (ChannelModel layout)
        h = h[:, None, :, None]

        if self._los:
            phi_0 = uniform((batch_size,), -PI, PI)
            arg_spec = (doppler[:, None] * sample_times
                        * np.cos(self._los_angle_of_arrival)
                        + phi_0[:, None])  # [B, T]
            h_spec = torch.complex(torch.cos(arg_spec),
                                   torch.sin(arg_spec))
            los_amp = float(np.sqrt(self._los_power))
            h = torch.cat([h_spec[:, None, None, None, None, None] * los_amp
                           + h[:, :, :, :, :, :1], h[:, :, :, :, :, 1:]],
                          dim=5)

        delays = torch.as_tensor(self.delays, dtype=rdtype, device=dev)
        delays = delays.expand(batch_size, 1, 1, m)

        if self._spatial_corr_mat_sqrt is not None:
            hp = h.permute(0, 1, 3, 5, 6, 2, 4)  # [B, 1, 1, m, T, nr, nt]
            hp = hp.reshape(hp.shape[:-2] + (nr * nt, 1))
            hp = torch.matmul(torch.as_tensor(self._spatial_corr_mat_sqrt,
                                              device=dev), hp)[..., 0]
            hp = hp.reshape(hp.shape[:-1] + (nr, nt))
            h = hp.permute(0, 1, 5, 2, 6, 3, 4)
        elif (self._rx_corr_mat_sqrt is not None
              or self._tx_corr_mat_sqrt is not None):
            hp = h.permute(0, 1, 3, 5, 6, 2, 4)
            if self._rx_corr_mat_sqrt is not None:
                hp = torch.matmul(torch.as_tensor(self._rx_corr_mat_sqrt,
                                                  device=dev), hp)
            if self._tx_corr_mat_sqrt is not None:
                tx = torch.as_tensor(self._tx_corr_mat_sqrt, device=dev)
                hp = torch.matmul(hp, tx.conj().transpose(-2, -1))
            h = hp.permute(0, 1, 5, 2, 6, 3, 4)
        return h.contiguous(), delays.contiguous()

    def _compute_doppler(self, speed):
        return 2. * PI * speed / SPEED_OF_LIGHT * self._carrier_frequency

    def _load_parameters(self, fname):
        with open(_MODELS_DIR / fname) as f:
            params = json.load(f)
        self._los = bool(params["los"])
        self._scale_delays = bool(params["scale_delays"])
        self._num_clusters = int(params["num_clusters"])
        delays = np.asarray(params["delays"], np.float64)
        mean_powers = np.power(10.0, np.asarray(params["powers"],
                                                np.float64) / 10.0)
        if self._los:
            # first entry is the specular component of the first path;
            # num_clusters already excludes it
            self._los_power = mean_powers[0]
            mean_powers = mean_powers[1:]
            delays = delays[1:]
            norm = mean_powers.sum() + self._los_power
            self._los_power = self._los_power / norm
            mean_powers = mean_powers / norm
        else:
            mean_powers = mean_powers / mean_powers.sum()
        self._delays = delays
        self._mean_powers = mean_powers
