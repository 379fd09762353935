"""PHY layer of the PyTorch port (counterpart of ``sionna_tpu.phy``)."""

from .config import config, dtypes
from .block import Object, Block
from . import constants, utils
from .constants import SPEED_OF_LIGHT, BOLTZMANN_CONSTANT, PI, H, ALPHA_MAX
from .mapping import (pam_gray, qam, pam, Constellation, Mapper, Demapper,
                      SymbolDemapper, SymbolLogits2LLRs, LLRs2SymbolLogits,
                      SymbolLogits2Moments, SymbolInds2Bits, QAM2PAM,
                      PAM2QAM, BinarySource, SymbolSource, QAMSource,
                      PAMSource)
from .channel import AWGN
from . import channel, fec, mimo, ofdm, signal
