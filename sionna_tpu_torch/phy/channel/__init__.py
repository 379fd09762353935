"""Channel models (counterpart of ``sionna_tpu.phy.channel``)."""

from .awgn import AWGN
from .channel_model import ChannelModel
from .rayleigh_block_fading import RayleighBlockFading
from .spatial_correlation import (SpatialCorrelation, KroneckerModel,
                                  PerColumnModel)
from .flat_fading_channel import (GenerateFlatFadingChannel,
                                  ApplyFlatFadingChannel, FlatFadingChannel)
from .apply_ofdm_channel import ApplyOFDMChannel
from .generate_ofdm_channel import GenerateOFDMChannel
from .ofdm_channel import OFDMChannel
from .apply_time_channel import ApplyTimeChannel
from .generate_time_channel import GenerateTimeChannel
from .time_channel import TimeChannel
from .discrete_channel import (BinaryMemorylessChannel,
                               BinarySymmetricChannel, BinaryErasureChannel,
                               BinaryZChannel)
from .cir_dataset import CIRDataset
from . import optical
from . import tr38901
from .utils import (subcarrier_frequencies, time_frequency_vector,
                    time_lag_discrete_time_channel, cir_to_ofdm_channel,
                    cir_to_time_channel, time_to_ofdm_channel, deg_2_rad,
                    rad_2_deg, wrap_angle_0_360, exp_corr_mat,
                    one_ring_corr_mat, drop_uts_in_sector,
                    set_3gpp_scenario_parameters, relocate_uts,
                    random_ut_properties, generate_uts_topology,
                    gen_single_sector_topology,
                    gen_single_sector_topology_interferers)
