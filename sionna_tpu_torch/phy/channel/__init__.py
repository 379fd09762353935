"""Channel models (counterpart of ``sionna_tpu.phy.channel``; the slice
ports AWGN)."""

from .awgn import AWGN
