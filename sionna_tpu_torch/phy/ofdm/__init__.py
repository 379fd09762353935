"""OFDM (counterpart of ``sionna_tpu.phy.ofdm``): the resource grid, the
OFDM modulator and demodulator, LS channel estimation with
nearest-neighbour, linear and LMMSE interpolation, the detectors and
equalizers, the post-equalization SINR and transmit precoding."""

from .pilot_pattern import (PilotPattern, EmptyPilotPattern,
                            KroneckerPilotPattern)
from .resource_grid import (ResourceGrid, ResourceGridMapper,
                            ResourceGridDemapper, RemoveNulledSubcarriers)
from .modulator import OFDMModulator
from .demodulator import OFDMDemodulator
from .channel_estimation import (BaseChannelEstimator,
                                 BaseChannelInterpolator,
                                 LSChannelEstimator,
                                 NearestNeighborInterpolator,
                                 LinearInterpolator, LMMSEInterpolator,
                                 LMMSEInterpolator1D, SpatialChannelFilter,
                                 tdl_freq_cov_mat, tdl_time_cov_mat)
from .detection import (OFDMDetector, OFDMDetectorWithPrior,
                        LinearDetector, MaximumLikelihoodDetector,
                        MaximumLikelihoodDetectorWithPrior,
                        KBestDetector, EPDetector, MMSEPICDetector)
from .equalization import (OFDMEqualizer, LMMSEEqualizer, ZFEqualizer,
                           MFEqualizer, PostEqualizationSINR,
                           LMMSEPostEqualizationSINR)
from .precoding import (RZFPrecoder, PrecodedChannel,
                        RZFPrecodedChannel, CBFPrecodedChannel,
                        EyePrecodedChannel)
