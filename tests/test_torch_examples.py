"""Runs each example program of the PyTorch port
(``sionna_tpu_torch/examples/0*.py``) on the CPU (``--cpu``) in its FAST
mode (``SIONNA_TPU_EXAMPLES_FAST``), each as a subprocess, as
``tests/test_examples.py`` runs the JAX package's, and checks the line
each one ends its report with. Example 01's measured BER must lie within
EX01_RTOL of the closed form at every Eb/N0 (its sweep stops at 2,000 bit
errors or more per point: 5 standard errors of the count are 11 %)."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "sionna_tpu_torch", "examples")
TIMEOUT_S = 120
EX01_RTOL = 0.15

LAST_LINES = {
    "01_uncoded_awgn_ber.py": r"^\s+12\.0 \| ",
    "02_coded_bler_ldpc_polar.py": r"^\s+3\.500 \| ",
    "03_mimo_ofdm_cdl.py": r"^\s+10\.000 \| ",
    "04_rt_coverage_map.py": r"^radio map: \d+x\d+ cells",
    "05_sys_multicell.py": r"^total: [\d.]+ Mbit over 5 slots \(eager slot "
                           r"loop on cpu\)",
}


def test_every_example_is_run():
    assert sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py")) \
        == sorted(LAST_LINES)
    assert not os.path.exists(os.path.join(EXAMPLES, "__init__.py"))


@pytest.mark.parametrize("script", sorted(LAST_LINES))
def test_example_runs_on_the_cpu(script):
    env = dict(os.environ, PYTHONPATH=REPO, SIONNA_TPU_EXAMPLES_FAST="1",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, script),
                          "--cpu"], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, (
        f"{script} rc={res.returncode}\n{res.stdout[-1500:]}\n"
        f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    assert re.match(LAST_LINES[script], lines[-1]), lines[-3:]
    if script.startswith("01"):
        rows = [ln.split("|") for ln in lines[-7:]]
        for _, measured, closed in rows:
            assert abs(float(measured) / float(closed) - 1) < EX01_RTOL
