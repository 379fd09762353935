"""BASELINE config 2 on the PyTorch port: 5G NR LDPC and Polar coded
BLER over AWGN.

QPSK, 5G LDPC BP-20 min-sum (the lifted engine: on the card its
hand-written CUDA kernel, K1's min-sum variant) and 5G Polar SCL-8 with
CRC-aided selection. Runs on the card (``config.device``) unless
``--cpu`` or ``SIONNA_TPU_EXAMPLES_CPU`` asks for the CPU;
``SIONNA_TPU_EXAMPLES_FAST`` shrinks the codes and the batches.

Usage (from the repository root):
    PYTHONPATH=. python sionna_tpu_torch/examples/02_coded_bler_ldpc_polar.py
"""

import os
import sys

import numpy as np

from sionna_tpu_torch.phy import config, BinarySource, Mapper, Demapper, AWGN
from sionna_tpu_torch.phy.fec.ldpc import LDPC5GEncoder, LDPC5GDecoder
from sionna_tpu_torch.phy.fec.polar import Polar5GEncoder, Polar5GDecoder
from sionna_tpu_torch.phy.utils import ebnodb2no, sim_ber

CPU = "--cpu" in sys.argv or bool(os.environ.get("SIONNA_TPU_EXAMPLES_CPU"))
FAST = bool(os.environ.get("SIONNA_TPU_EXAMPLES_FAST"))


def make_mc_fun(k, n, enc, dec):
    src = BinarySource()
    mapper = Mapper("qam", 2)
    demapper = Demapper("app", "qam", 2)
    channel = AWGN()

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, 2, k / n)
        u = src([batch_size, k])
        y = channel(mapper(enc(u)), no)
        return u, dec(demapper(y, no))

    return mc_fun


def main():
    if CPU:
        config.device = "cpu"
    config.seed = 42
    k, n = (120, 240) if FAST else (400, 800)
    ebno_dbs = np.arange(1.0, 4.0, 0.5)
    batch = 256 if FAST else 1024
    max_iter = 4 if FAST else 20

    def ldpc():
        enc = LDPC5GEncoder(k, n)
        return enc, LDPC5GDecoder(enc, num_iter=20, cn_update="minsum")

    def polar():
        enc = Polar5GEncoder(*((32, 64) if FAST else (64, 128)))
        return enc, Polar5GDecoder(enc, dec_type="SCL", list_size=8)

    for name, make in (("5G LDPC BP-20 minsum", ldpc),
                       ("5G Polar SCL-8+CRC", polar)):
        enc, dec = make()
        print(f"\n=== {name} (k={enc.k}, n={enc.n}) ===")
        sim_ber(make_mc_fun(enc.k, enc.n, enc, dec), ebno_dbs,
                batch_size=batch, max_mc_iter=max_iter,
                num_target_block_errors=100, verbose=True)


if __name__ == "__main__":
    main()
