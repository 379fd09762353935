"""Universal linear codes (counterpart of ``sionna_tpu.phy.fec.linear``)."""

from .encoding import LinearEncoder
from .decoding import OSDecoder
