"""Polar codes (counterpart of ``sionna_tpu.phy.fec.polar``)."""

from .encoding import PolarEncoder, Polar5GEncoder
from .decoding import (PolarSCDecoder, PolarSCLDecoder, PolarBPDecoder,
                       Polar5GDecoder)
from .utils import (generate_5g_ranking, generate_polar_transform_mat,
                    generate_rm_code, generate_dense_polar)
