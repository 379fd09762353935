"""Channel models (counterpart of ``sionna_tpu.phy.channel``; the port
has AWGN and the OFDM channel with the TR 38.901 TDL models)."""

from .awgn import AWGN
from .channel_model import ChannelModel
from .apply_ofdm_channel import ApplyOFDMChannel
from .generate_ofdm_channel import GenerateOFDMChannel
from .ofdm_channel import OFDMChannel
from . import tr38901
from .utils import subcarrier_frequencies, cir_to_ofdm_channel
