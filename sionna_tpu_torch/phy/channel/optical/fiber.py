"""Split-step Fourier method fiber model (counterpart of
``sionna_tpu/phy/channel/optical/fiber.py``).

The fixed-step symmetric SSFM is a Python loop of ``torch.fft`` calls
(the JAX package's ``fori_loop``); its window and its two dispersion
phasors (full and half step) are made on the device once per signal
length and kept as buffers. The adaptive mode carries ``remaining`` and
``dz`` as tensors of the real dtype, as JAX does, and reads the loop's
condition back from the device once per step. All parameters follow the
normalized-unit convention (``t_norm``).
"""

import math

import numpy as np
import torch

from ... import constants
from ...block import Block
from ...config import config
from ..utils import time_frequency_vector
from .edfa import complex_noise

__all__ = ["SSFM"]


class SSFM(Block):
    """Split-step Fourier method for the NLSE, or the Manakov equation
    (``with_manakov``, inputs [..., 2, num_samples]).

    ``n_ssfm`` is the number of steps, or "adaptive": steps of
    ``phase_inc / gamma / max|q|^2`` (at most what remains). The ASE
    noise of distributed amplification comes from ``generator`` when
    given, else from ``config.generator`` of the input's device.
    ``swap_memory`` is accepted for the reference's signature and has
    no effect.
    """

    def __init__(self, alpha=0.046, beta_2=-21.67, f_c=193.55e12,
                 gamma=1.27, half_window_length=0, length=80, n_ssfm=1,
                 n_sp=1.0, sample_duration=1.0, t_norm=1e-12,
                 with_amplification=False, with_attenuation=True,
                 with_dispersion=True, with_manakov=False,
                 with_nonlinearity=True, phase_inc=1e-4,
                 swap_memory=True, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._alpha = float(alpha)
        self._beta_2 = float(beta_2)
        self._f_c = float(f_c)
        self._gamma = float(gamma)
        self._half_window_length = int(half_window_length)
        self._length = float(length)
        self._phase_inc = float(phase_inc)

        if n_ssfm == "adaptive":
            self._n_ssfm = -1
        elif isinstance(n_ssfm, int):
            if n_ssfm <= 0:
                raise ValueError("n_ssfm must be positive.")
            self._n_ssfm = n_ssfm
        else:
            raise ValueError(
                "Unsupported n_ssfm; must be int or 'adaptive'.")
        self._dz = self._length / max(self._n_ssfm, 1)
        self._n_sp = float(n_sp)
        self._t_norm = float(t_norm)
        self._sample_duration = float(sample_duration)

        self._with_amplification = bool(with_amplification)
        self._with_attenuation = bool(with_attenuation)
        self._with_dispersion = bool(with_dispersion)
        self._with_manakov = bool(with_manakov)
        self._with_nonlinearity = bool(with_nonlinearity)

        # distributed ASE noise density (W/Hz) and power
        self._rho_n = (constants.H * self._f_c * self._alpha
                       * self._length * self._n_sp)
        self._p_n_ase = self._rho_n / self._sample_duration / self._t_norm
        if self._with_manakov:
            self._p_n_ase /= 2.0

        hw = self._half_window_length
        n = np.arange(2 * hw)
        self._window_edge = 0.54 - 0.46 * np.cos(
            2 * np.pi * n / max(2 * hw - 1, 1))
        # per signal length: the window, the frequency grid and the full
        # and half step dispersion phasors (FFT order)
        self._n = None
        for name in ("_window", "_freq", "_disp", "_disp_half"):
            self.register_buffer(name, None, persistent=False)
        #: steps taken by the last call
        self.steps = 0

    def _tables_for(self, n, device):
        """Makes the length-``n`` tables on ``device`` unless it holds
        them already."""
        if self._n == n and self._freq.device == device:
            return
        hw = self._half_window_length
        w = np.ones(n)
        if hw > 0:
            w[:hw] = self._window_edge[:hw]
            w[-hw:] = self._window_edge[hw:]
        self._window = torch.as_tensor(w, device=device).to(
            self.rdtype).to(self.cdtype)
        _, self._freq = time_frequency_vector(
            n, self._sample_duration, precision=self.precision,
            device=device)
        if self._n_ssfm != -1 and self._with_dispersion:
            self._disp = self._phasor(self._dz)
            self._disp_half = self._phasor(self._dz / 2.0)
        self._n = n

    def _phasor(self, dz):
        """The dispersion phasor of a step ``dz`` (a float or a 0-dim
        tensor of the real dtype), in FFT order."""
        phase = (-self._beta_2 / 2.0 * dz
                 * (2 * constants.PI * self._freq) ** 2).to(self.rdtype)
        return torch.fft.fftshift(self._rotation(phase), dim=-1)

    def _rotation(self, phase):
        """exp(1j phase) of the complex dtype. Its cos and sin are taken
        in float64 and rounded once, so that every device gives the same
        phasor: f32 cos/sin differ by an ULP between libraries, and a
        step's phasor error adds up over the steps."""
        phase = phase.to(torch.float64)
        return torch.complex(torch.cos(phase), torch.sin(phase)).to(
            self.cdtype)

    def _linear(self, q, dz, disp):
        if self._with_dispersion:
            q = torch.fft.ifft(torch.fft.fft(q, dim=-1) * disp, dim=-1)
        if isinstance(dz, torch.Tensor):
            if self._with_attenuation:
                q = q * torch.exp(-self._alpha / 2.0 * dz).to(self.cdtype)
            if self._with_amplification:
                q = q * torch.exp(self._alpha / 2.0 * dz).to(self.cdtype)
            return q
        # a fixed step: the factors in float64, as Python computes them
        if self._with_attenuation:
            q = q * math.exp(-self._alpha / 2.0 * dz)
        if self._with_amplification:
            q = q * math.exp(self._alpha / 2.0 * dz)
        return q

    def _noise(self, q, dz, generator):
        if not self._with_amplification:
            return q
        step_noise = self._p_n_ase * dz / self._length / 2.0
        if isinstance(step_noise, torch.Tensor):
            std = torch.sqrt(step_noise.to(self.rdtype))
        else:
            std = float(np.sqrt(self.np_rdtype(step_noise)))
        return q + complex_noise(q.shape, std, self.rdtype, generator,
                                 q.device)

    def _nonlinear(self, q, dz):
        if not self._with_nonlinearity:
            return q
        if self._with_manakov:
            power = torch.sum(torch.abs(q) ** 2, dim=-2, keepdim=True)
            phase = -(8.0 / 9.0) * power * self._gamma * dz
        else:
            phase = -torch.abs(q) ** 2 * self._gamma * dz
        return q * self._rotation(phase.to(self.rdtype))

    def forward(self, x, generator=None):
        x = x.to(self.cdtype)
        if self._with_manakov and x.shape[-2] != 2:
            raise ValueError("Manakov requires two polarizations on "
                             "the second-to-last axis.")
        if generator is None and self._with_amplification:
            generator = config.generator(x.device)
        self._tables_for(x.shape[-1], x.device)

        if self._n_ssfm == -1:
            # adaptive steps from the largest power of the signal
            rdtype = self.rdtype
            inc = torch.tensor(self._phase_inc / self._gamma, dtype=rdtype,
                               device=x.device)
            remaining = torch.tensor(self._length, dtype=rdtype,
                                     device=x.device)
            steps = 0
            while bool(remaining >= 1e-3):
                max_power = torch.max(torch.abs(x) ** 2)
                dz = torch.minimum(inc / max_power, remaining)
                x = x * self._window
                disp = self._phasor(dz) if self._with_dispersion else None
                x = self._linear(x, dz, disp)
                x = self._nonlinear(x, dz)
                x = self._noise(x, dz, generator)
                remaining = remaining - dz
                steps += 1
            self.steps = steps
            return x

        dz = self._dz
        # symmetric SSFM: half linear, (N-1) x (window, N, noise, D),
        # the last N and noise, half linear
        x = self._linear(x, dz / 2.0, self._disp_half)
        for _ in range(self._n_ssfm - 1):
            x = x * self._window
            x = self._nonlinear(x, dz)
            x = self._noise(x, dz, generator)
            x = self._linear(x, dz, self._disp)
        x = self._nonlinear(x, dz)
        x = self._noise(x, dz, generator)
        x = self._linear(x, dz / 2.0, self._disp_half)
        self.steps = self._n_ssfm
        return x
