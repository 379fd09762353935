"""The cells on a CUDA card (marked ``card``; skipped without one): each
cell's command line prints its result line, correct, with every metric
of its kind, and the control fails a limit at the cell's own size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    _needs_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    names = ({m["name"] for m in SPEC["end_to_end"]} if not trace else
             {m["name"] for m in SPEC["per_layer"]
              if cell in m.get("workloads", [cell])})
    assert set(res["metrics"]) == names
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    _needs_card()
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "11", "--control-seeds", "11", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert any(summary["control_min"][k] > lim
               for k, lim in summary["limits"].items())
