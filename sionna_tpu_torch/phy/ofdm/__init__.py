"""OFDM (counterpart of ``sionna_tpu.phy.ofdm``; the port has the
resource grid, LS channel estimation with nearest-neighbour, linear and
LMMSE interpolation, the LMMSE, ZF and MF equalizers and the
post-equalization SINR)."""

from .pilot_pattern import (PilotPattern, EmptyPilotPattern,
                            KroneckerPilotPattern)
from .resource_grid import (ResourceGrid, ResourceGridMapper,
                            ResourceGridDemapper, RemoveNulledSubcarriers)
from .channel_estimation import (BaseChannelEstimator,
                                 BaseChannelInterpolator,
                                 LSChannelEstimator,
                                 NearestNeighborInterpolator,
                                 LinearInterpolator, LMMSEInterpolator,
                                 LMMSEInterpolator1D, SpatialChannelFilter,
                                 tdl_freq_cov_mat, tdl_time_cov_mat)
from .detection import OFDMDetector
from .equalization import (OFDMEqualizer, LMMSEEqualizer, ZFEqualizer,
                           MFEqualizer, PostEqualizationSINR,
                           LMMSEPostEqualizationSINR)
