"""3GPP TR 38.901 channel models (counterpart of
``sionna_tpu.phy.channel.tr38901``; the port has the TDL models)."""

from .tdl import TDL
