"""Forward error correction (counterpart of ``sionna_tpu.phy.fec``; the
port has 5G LDPC and the row-column interleaver)."""

from . import interleaving, ldpc
