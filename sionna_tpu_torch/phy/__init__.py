"""PHY layer of the PyTorch port (counterpart of ``sionna_tpu.phy``)."""

from .config import config, dtypes
from .block import Object, Block
from . import constants, utils
from .mapping import (pam_gray, qam, pam, Constellation, Mapper, Demapper,
                      SymbolLogits2LLRs, BinarySource)
from .channel import AWGN
from . import channel, fec, mimo, ofdm
