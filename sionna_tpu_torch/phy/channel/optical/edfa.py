"""Erbium-doped fiber amplifier (counterpart of
``sionna_tpu/phy/channel/optical/edfa.py``)."""

import math

import numpy as np
import torch

from ... import constants
from ...block import Block
from ...config import config

__all__ = ["EDFA"]


def complex_noise(shape, std, dtype, generator, device):
    """Complex Gaussian noise of ``shape``, each part of standard
    deviation ``std`` (a float, or a tensor that broadcasts)."""
    nr = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    ni = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.complex(std * nr, std * ni)


class EDFA(Block):
    """Amplifies by sqrt(g) and adds ASE noise of noise figure ``f``
    (spectral density n_sp (g - 1) h f_c with n_sp = f/2 g/(g - 1), and
    n_sp = 0 at g = 1), per polarization if
    ``with_dual_polarization``. The noise comes from ``generator`` when
    given, else from ``config.generator`` of the input's device."""

    def __init__(self, g=4.0, f=7.0, f_c=193.55e12, dt=1e-12,
                 with_dual_polarization=False, precision=None, device=None):
        super().__init__(precision=precision, device=device)
        self._g = float(g)
        self._f = float(f)
        self._f_c = float(f_c)
        self._dt = float(dt)
        if not isinstance(with_dual_polarization, bool):
            raise TypeError("with_dual_polarization must be bool.")
        self._with_dual_polarization = with_dual_polarization

        if self._g == 1.0:
            self._n_sp = 0.0
        else:
            self._n_sp = self._f / 2.0 * self._g / (self._g - 1.0)
        self._rho_n_ase = (self._n_sp * (self._g - 1.0) * constants.H
                           * self._f_c)
        self._p_n_ase = 2.0 * self._rho_n_ase / self._dt
        if self._with_dual_polarization:
            self._p_n_ase /= 2.0

    def forward(self, x, generator=None):
        x = x.to(self.cdtype)
        if self._with_dual_polarization and x.shape[-2] != 2:
            raise ValueError("Dual polarization requires two "
                             "polarizations on the second-to-last axis.")
        if generator is None:
            generator = config.generator(x.device)
        # the standard deviation rounded as the JAX package rounds it:
        # sqrt in the real dtype of the value cast to it
        std = float(np.sqrt(self.np_rdtype(self._p_n_ase / 2.0)))
        n = complex_noise(x.shape, std, self.rdtype, generator, x.device)
        return x * math.sqrt(self._g) + n
