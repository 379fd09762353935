"""Tests of the benchmark. CPU tests rehearse the cells at a tiny batch;
tests marked ``card`` need a CUDA card and skip without one (decided
inside each test). Run from the repository's root:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "benchmark"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
