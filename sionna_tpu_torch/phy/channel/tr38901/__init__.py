"""3GPP TR 38.901 channel models (counterpart of
``sionna_tpu.phy.channel.tr38901``; the port has the TDL and CDL models
with the antenna arrays and the step-11 coefficient generator; the
system-level models follow, ROADMAP.md queue 1 item 18)."""

from .tdl import TDL
from .antenna import (AntennaElement, AntennaPanel, PanelArray, Antenna,
                      AntennaArray)
from .rays import Rays
from .channel_coefficients import Topology, ChannelCoefficientsGenerator
from .cdl import CDL
