"""Physical constants (counterpart of ``sionna_tpu/phy/constants.py``)."""

import scipy.constants

ALPHA_MAX = 32  # Maximum pathloss exponent value
BOLTZMANN_CONSTANT = scipy.constants.Boltzmann  # J/K
DIELECTRIC_PERMITTIVITY_VACUUM = scipy.constants.epsilon_0  # F/m
H = scipy.constants.Planck  # J/Hz
PI = scipy.constants.pi
SPEED_OF_LIGHT = scipy.constants.speed_of_light  # m/s
