"""sim_ber.iter_ms_p95: the 95th percentile, over every MC iteration of
the window, of the device time between the CUDA events recorded at the
start of consecutive ``mc_fun`` calls (the last one to its own end); no
synchronize inside the window. Layer: the MC driver,
``phy/utils/sim.py``."""

import numpy as np


def read(run):
    if not run.iter_ms:
        return None
    return float(np.percentile(np.asarray(run.iter_ms), 95))
