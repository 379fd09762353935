"""MIMO (counterpart of ``sionna_tpu.phy.mimo``; the port has stream
management, channel whitening and the LMMSE, ZF and MF equalizers)."""

from .stream_management import StreamManagement
from .equalization import (lmmse_matrix, lmmse_equalizer,
                           zf_equalizer, mf_equalizer)
from .utils import whiten_channel
