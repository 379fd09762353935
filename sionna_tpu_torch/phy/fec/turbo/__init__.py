"""Turbo codes (counterpart of ``sionna_tpu.phy.fec.turbo``)."""

from .encoding import TurboEncoder
from .decoding import TurboDecoder
from .utils import polynomial_selector, puncture_pattern, TurboTermination
