"""5G LDPC codes (counterpart of ``sionna_tpu.phy.fec.ldpc``)."""

from .encoding import LDPC5GEncoder
from .decoding import LDPC5GDecoder, LDPC5GLiftedBP
