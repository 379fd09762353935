"""Signal processing (counterpart of ``sionna_tpu.phy.signal``)."""

from .utils import convolve, fft, ifft, empirical_psd, empirical_aclr
from .window import (Window, CustomWindow, HannWindow, HammingWindow,
                     BlackmanWindow)
from .filter import (Filter, RaisedCosineFilter, RootRaisedCosineFilter,
                     SincFilter, CustomFilter)
from .upsampling import Upsampling
from .downsampling import Downsampling
