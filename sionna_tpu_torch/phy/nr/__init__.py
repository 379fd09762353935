"""5G NR sub-package (counterpart of ``sionna_tpu.phy.nr``): the PUSCH
configuration tree (plain NumPy on the host, as in the JAX package), the
transport-block encoder and decoder, layer mapping, the DMRS pilot
pattern, codebook precoding, LS channel estimation with CDM despreading,
the PUSCH transmitter and receiver, and the TS 38.214 MCS and
transport-block procedures of ``utils``.

The blocks carry no trainable weights: a test builds the JAX package's
and the port's configurations from the same settings, so no weight
transfer is needed."""

from .config import Config
from .carrier_config import CarrierConfig
from .pusch_dmrs_config import PUSCHDMRSConfig
from .tb_config import TBConfig
from .pusch_config import PUSCHConfig, check_pusch_configs
from .layer_mapping import LayerMapper, LayerDemapper
from .tb_encoder import TBEncoder
from .tb_decoder import TBDecoder
from .pusch_pilot_pattern import PUSCHPilotPattern
from .pusch_precoder import PUSCHPrecoder
from .pusch_channel_estimation import PUSCHLSChannelEstimator
from .pusch_transmitter import PUSCHTransmitter
from .pusch_receiver import PUSCHReceiver
from . import utils
from .utils import (generate_prng_seq, decode_mcs_index,
                    decode_mcs_index_jit, calculate_tb_size,
                    calculate_cb_size_jit, calculate_num_coded_bits)
