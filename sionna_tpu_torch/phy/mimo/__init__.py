"""MIMO (counterpart of ``sionna_tpu.phy.mimo``; the port has stream
management, channel whitening and LMMSE equalization)."""

from .stream_management import StreamManagement
from .equalization import lmmse_matrix, lmmse_equalizer
from .utils import whiten_channel
