"""Forward error correction (counterpart of ``sionna_tpu.phy.fec``; the
slice ports 5G LDPC)."""
