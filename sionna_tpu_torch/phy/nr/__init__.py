"""5G NR sub-package (counterpart of ``sionna_tpu.phy.nr``; the port
has its ``utils`` module, which the SYS package needs: the TS 38.214 MCS
and transport-block procedures and the coded AWGN channel of the BLER
tables. The rest of ``phy/nr`` is ROADMAP.md queue 1 item 19)."""

from . import utils
from .utils import (generate_prng_seq, decode_mcs_index,
                    decode_mcs_index_jit, calculate_tb_size,
                    calculate_cb_size_jit, calculate_num_coded_bits)
