"""MIMO (counterpart of ``sionna_tpu.phy.mimo``): stream management,
the equalizers and detectors, precoding and the complex/real and
whitening utilities."""

from .stream_management import StreamManagement
from .equalization import (lmmse_matrix, lmmse_equalizer,
                           zf_equalizer, mf_equalizer)
from .utils import (complex2real_vector, real2complex_vector,
                    complex2real_matrix, real2complex_matrix,
                    complex2real_covariance, real2complex_covariance,
                    complex2real_channel, real2complex_channel,
                    whiten_channel, List2LLR, List2LLRSimple)
from .detection import (LinearDetector, MaximumLikelihoodDetector,
                        KBestDetector, EPDetector, MMSEPICDetector)
from .precoding import (rzf_precoding_matrix, cbf_precoding_matrix,
                        rzf_precoder, grid_of_beams_dft_ula,
                        grid_of_beams_dft, flatten_precoding_mat,
                        normalize_precoding_power)
