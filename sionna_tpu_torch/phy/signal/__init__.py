"""Signal utilities (counterpart of ``sionna_tpu.phy.signal``; the port
has ``utils.py``; the filters, windows and up/down-sampling follow,
ROADMAP.md queue 1 item 17)."""

from .utils import convolve, fft, ifft, empirical_psd, empirical_aclr
