"""3GPP TR 38.901 channel models (counterpart of
``sionna_tpu.phy.channel.tr38901``)."""

from .tdl import TDL
from .antenna import (AntennaElement, AntennaPanel, PanelArray, Antenna,
                      AntennaArray)
from .rays import Rays, RaysGenerator
from .lsp import LSP, LSPGenerator
from .channel_coefficients import Topology, ChannelCoefficientsGenerator
from .cdl import CDL
from .system_level_scenario import SystemLevelScenario
from .scenarios import UMaScenario, UMiScenario, RMaScenario
from .system_level_channel import SystemLevelChannel, UMa, UMi, RMa
