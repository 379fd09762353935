"""Optical channel models (counterpart of
``sionna_tpu.phy.channel.optical``)."""

from .fiber import SSFM
from .edfa import EDFA
