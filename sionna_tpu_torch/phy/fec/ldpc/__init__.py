"""LDPC codes (counterpart of ``sionna_tpu.phy.fec.ldpc``)."""

from .encoding import LDPC5GEncoder
from .utils import (EXITCallback, DecoderStatisticsCallback,
                    WeightedBPCallback)
from .decoding import (LDPCBPDecoder, LDPC5GDecoder, LDPC5GLiftedBP,
                       cn_update_minsum, cn_update_offset_minsum,
                       cn_update_tanh, cn_update_phi, vn_update_sum,
                       cn_node_update_identity, vn_node_update_identity)
