"""BASELINE config 1 on the PyTorch port: uncoded 16-QAM over AWGN.

Mapper -> AWGN -> Demapper, swept with the Monte-Carlo loop (sim_ber) and
checked against the closed-form QAM BER. Runs on the card
(``config.device``) unless ``--cpu`` or ``SIONNA_TPU_EXAMPLES_CPU`` asks
for the CPU; ``SIONNA_TPU_EXAMPLES_FAST`` shrinks the batch.

Usage (from the repository root):
    PYTHONPATH=. python sionna_tpu_torch/examples/01_uncoded_awgn_ber.py
"""

import os
import sys

import numpy as np
from scipy.special import erfc

from sionna_tpu_torch.phy import config, BinarySource, Mapper, Demapper, AWGN
from sionna_tpu_torch.phy.utils import ebnodb2no, sim_ber

CPU = "--cpu" in sys.argv or bool(os.environ.get("SIONNA_TPU_EXAMPLES_CPU"))
FAST = bool(os.environ.get("SIONNA_TPU_EXAMPLES_FAST"))
NBPS = 4  # 16-QAM


def theoretical_ber_16qam(ebno_db):
    """Gray-labeled 16-QAM BER over AWGN:
    Pb ~= (3/8) erfc(sqrt(0.4 Eb/N0))."""
    ebno = 10 ** (np.asarray(ebno_db) / 10)
    return 3 / 8 * erfc(np.sqrt(0.4 * ebno))


def main():
    if CPU:
        config.device = "cpu"
    config.seed = 42
    src = BinarySource()
    mapper = Mapper("qam", NBPS)
    demapper = Demapper("app", "qam", NBPS, hard_out=True)
    channel = AWGN()

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, NBPS, 1.0)
        b = src([batch_size, 2048])
        y = channel(mapper(b), no)
        return b, demapper(y, no)

    ebno_dbs = np.arange(0., 14., 2.)
    ber, _ = sim_ber(mc_fun, ebno_dbs, batch_size=256 if FAST else 4096,
                     max_mc_iter=10 if FAST else 50,
                     num_target_bit_errors=2000, verbose=True)

    print("\nEb/No [dB] | measured BER | closed form")
    for e, b in zip(ebno_dbs, ber.numpy()):
        print(f"{e:10.1f} | {b:12.3e} | {theoretical_ber_16qam(e):.3e}")


if __name__ == "__main__":
    main()
