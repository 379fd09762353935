"""Forward error correction (counterpart of ``sionna_tpu.phy.fec``; the
port has LDPC, the linear codes, the FEC utilities and the row-column
interleaver)."""

from . import interleaving, ldpc, linear, utils
