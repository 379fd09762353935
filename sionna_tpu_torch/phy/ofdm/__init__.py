"""OFDM (counterpart of ``sionna_tpu.phy.ofdm``; the slice ports the
resource grid, LS channel estimation with nearest-neighbour
interpolation and LMMSE equalization)."""

from .pilot_pattern import (PilotPattern, EmptyPilotPattern,
                            KroneckerPilotPattern)
from .resource_grid import (ResourceGrid, ResourceGridMapper,
                            RemoveNulledSubcarriers)
from .channel_estimation import (BaseChannelEstimator,
                                 BaseChannelInterpolator,
                                 LSChannelEstimator,
                                 NearestNeighborInterpolator)
from .detection import OFDMDetector
from .equalization import OFDMEqualizer, LMMSEEqualizer
