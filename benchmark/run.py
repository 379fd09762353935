"""Entry point of the benchmark of ``sionna_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout; see ``harness.py``. The kernels' build
directory (``build/sionna_tpu_torch/``) and PyTorch's extension and
Triton caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
