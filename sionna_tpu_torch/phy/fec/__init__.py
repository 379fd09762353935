"""Forward error correction (counterpart of ``sionna_tpu.phy.fec``)."""

from . import crc
from . import scrambling
from . import interleaving
from . import ldpc
from . import polar
from . import conv
from . import turbo
from . import linear
from . import utils
from .crc import CRCEncoder, CRCDecoder
from .scrambling import Scrambler, TB5GScrambler, Descrambler
from .interleaving import (RowColumnInterleaver, RandomInterleaver,
                           Deinterleaver, Turbo3GPPInterleaver)
