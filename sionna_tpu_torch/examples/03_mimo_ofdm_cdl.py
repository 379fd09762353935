"""BASELINE config 3 on the PyTorch port: a 4x4 MIMO-OFDM link over a
3GPP CDL channel.

LS channel estimation + LMMSE detection + 5G LDPC decoding (min-sum
BP-12: on the card K1's min-sum variant). ``distribute="all"`` spreads
the Monte-Carlo batch over the ranks of a ``torch.distributed`` group
when the script runs under ``torchrun`` with
``init_multihost()`` (``--distributed``), and is this process alone
otherwise. Runs on the card (``config.device``) unless ``--cpu`` or
``SIONNA_TPU_EXAMPLES_CPU`` asks for the CPU; ``SIONNA_TPU_EXAMPLES_FAST``
shrinks the grid and the sweep.

Usage (from the repository root):
    PYTHONPATH=. python sionna_tpu_torch/examples/03_mimo_ofdm_cdl.py
    PYTHONPATH=. torchrun --nproc_per_node=4 \
        sionna_tpu_torch/examples/03_mimo_ofdm_cdl.py --distributed
"""

import os
import sys

import numpy as np

from sionna_tpu_torch.phy import config, BinarySource, Mapper
from sionna_tpu_torch.phy.mimo import StreamManagement
from sionna_tpu_torch.phy.ofdm import (ResourceGrid, ResourceGridMapper,
                                       LSChannelEstimator, LinearDetector)
from sionna_tpu_torch.phy.channel import OFDMChannel
from sionna_tpu_torch.phy.channel.tr38901 import CDL, AntennaArray
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GEncoder, LDPC5GDecoder
from sionna_tpu_torch.phy.utils import ebnodb2no, init_multihost, sim_ber

CPU = "--cpu" in sys.argv or bool(os.environ.get("SIONNA_TPU_EXAMPLES_CPU"))
FAST = bool(os.environ.get("SIONNA_TPU_EXAMPLES_FAST"))
NBPS, CODERATE, NUM_STREAMS = 4, 0.5, 4


def main():
    if CPU:
        config.device = "cpu"
    if "--distributed" in sys.argv:
        init_multihost()
    config.seed = 42
    fft_size = 32 if FAST else 128
    rg = ResourceGrid(num_ofdm_symbols=14, fft_size=fft_size,
                      subcarrier_spacing=30e3, num_tx=1,
                      num_streams_per_tx=NUM_STREAMS,
                      pilot_pattern="kronecker",
                      pilot_ofdm_symbol_indices=[2, 11])
    sm = StreamManagement(np.array([[1]]), NUM_STREAMS)
    n = int(rg.num_data_symbols) * NBPS
    k = int(n * CODERATE)

    def array():
        return AntennaArray(num_rows=1, num_cols=2, polarization="dual",
                            polarization_type="cross",
                            antenna_pattern="38.901",
                            carrier_frequency=3.5e9)

    cdl = CDL("B", 100e-9, 3.5e9, array(), array(), "uplink", min_speed=3.)
    src = BinarySource()
    enc = LDPC5GEncoder(k, n)
    mapper = Mapper("qam", NBPS)
    rg_mapper = ResourceGridMapper(rg)
    channel = OFDMChannel(cdl, rg, normalize_channel=True)
    est = LSChannelEstimator(rg, interpolation_type="lin")
    det = LinearDetector("lmmse", "bit", "app", rg, sm, "qam", NBPS)
    dec = LDPC5GDecoder(enc, num_iter=12, cn_update="minsum")

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, NBPS, CODERATE, rg)
        b = src([batch_size, 1, NUM_STREAMS, k])
        y = channel(rg_mapper(mapper(enc(b))), no)
        h_hat, err_var = est(y, no)
        llr = det(y, h_hat, err_var, no)
        return b, dec(llr)

    ebno_dbs = [2., 6., 10.] if FAST else np.arange(0., 14., 2.)
    sim_ber(mc_fun, ebno_dbs, batch_size=16 if FAST else 64,
            max_mc_iter=2 if FAST else 20,
            num_target_block_errors=None if FAST else 100,
            verbose=True, distribute="all")


if __name__ == "__main__":
    main()
