"""Convolutional codes (counterpart of ``sionna_tpu.phy.fec.conv``)."""

from .encoding import ConvEncoder
from .decoding import ViterbiDecoder, BCJRDecoder
from .utils import Trellis, polynomial_selector
