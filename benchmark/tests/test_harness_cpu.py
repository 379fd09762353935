"""The harness on the CPU: every cell end to end at a tiny batch, the
traced run, the per-layer readers on a recorded trace, the work counts,
the command line without a card, and the import check."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import harness
from reference.ldpc5g import Code
from reference.work import lifted_bp_work

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIG = {w["name"]: w["config"] for w in SPEC["workloads"]}
TINY = {"batch_size": 2, "device_iters": 1, "capture": 2,
        "trace_chunks": [1, 2]}
# the CPU rehearsals' sizes: the PUSCH at 16 PRBs (its interpolation
# operator is built on the host)
SMALL = {"pusch_273prb": {"carrier": {"n_size_grid": 16}}}


def rehearse(cell, trace=0, seed=2 ** 31 + 77, **kw):
    return harness.run(cell, seed, 0.5, trace, time.perf_counter(),
                       device="cpu", overrides=dict(TINY),
                       config_overrides=SMALL.get(CONFIG[cell]), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearses_on_cpu(cell):
    res, rows = rehearse(cell)
    assert res["correct"], rows
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"info_bit_throughput", "setup_s"}
    assert list(res)[-1] == "checks"
    assert set(rows) == set(json.loads(
        (ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text()
    )["limits"])


def test_traced_run_on_cpu_has_trace_keys():
    res, _ = rehearse(CELLS[0], trace=1)
    assert res["correct"]
    assert "busy_s" in res["device"] and "window_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device readers find nothing to read
    assert "device.idle_pct" not in res["metrics"]


def _recorded_trace(tmp_path):
    """A chrome trace in the profiler's format: two K1 launches, a copy,
    host ranges; 10 ms of window, 5 ms of it busy."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "decode",
         "ts": 0.0, "dur": 10000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item",
         "ts": 6000.0, "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "ts": 1000.0, "dur": 2000.0,
         "name": "void lifted_bp_kernel<false, 0, false>(float const*)"},
        {"ph": "X", "cat": "kernel", "ts": 2500.0, "dur": 2500.0,
         "name": "void lifted_bp_kernel<false, 0, false>(float const*)"},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 9000.0, "dur": 1000.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return harness.Trace(path)


def test_trace_reduction(tmp_path):
    tr = _recorded_trace(tmp_path)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.005)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(0.004)
    assert tr.device_ops()[0][1] == pytest.approx(0.0045)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_parses_recorded_run(metric, tmp_path):
    tr = _recorded_trace(tmp_path)
    stages = {s: [1.0, 3.0] for s in
              ("tx", "channel", "estimation", "detection", "decode")}
    work = {"k1": {"flops": 67e9, "bytes": 1e6},
            "k3": {"flops": 67e9, "bytes": 1e6}}
    rec = harness.RunRecord(list(range(1, 101)), stages, tr, 3 * 2 ** 30,
                            work, {"fp32_ops_s": 67e12,
                                   "hbm_bytes_s": 3.35e12})
    cell = harness.Cell(CELLS[0])
    reader = harness.load_module(
        ROOT / "benchmark" / "metrics" / f"{metric}.py", "m")
    value = reader.read(rec)
    expected = {
        "sim_ber.iter_ms_p95": 95.05,
        "device.idle_pct": 50.0,
        "device.peak_mem_gib": 3.0,
        # 2 launches of 1 ms least time over 4.5 ms of device time
        "k1.roofline_pct": 100 * 2e-3 / 4.5e-3,
        "k3.roofline_pct": None,
    }.get(metric, 2.0)
    assert cell is not None
    if expected is None:
        assert value is None
    else:
        assert value == pytest.approx(expected)
    empty = harness.RunRecord([], {}, None, 0, {}, None)
    assert reader.read(empty) is None


def test_work_counts_pin_the_flagship_code():
    code = Code(6144, 12288)
    assert (code.num_edges, code.num_vns, code.num_cns) == (59520, 13056,
                                                            6720)
    k1 = lifted_bp_work(code, 2048, 20, layered=False)
    k3 = lifted_bp_work(code, 2048, 10, layered=True)
    assert k1 == {"flops": 59_580_088_320.0, "bytes": 213_909_504.0}
    assert k3 == {"flops": 28_036_300_800.0, "bytes": 213_909_504.0}


def test_command_line_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_line_fails_without_the_program(tmp_path):
    (tmp_path / "benchmark").symlink_to(ROOT / "benchmark")
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    """Every module a CPU rehearsal of each cell loads, compared by its
    top-level name, whole."""
    code = (
        "import sys, time; sys.path[:0] = [{root!r}, {bench!r}];"
        "import harness;"
        "[harness.run(c, 5, 0.2, t, time.perf_counter(), device='cpu',"
        " overrides={tiny!r}, config_overrides={small!r}.get({config!r}[c]))"
        " for c in {cells!r} for t in (0, 1)];"
        "print(sorted({{m.split('.', 1)[0] for m in sys.modules}}))"
    ).format(root=str(ROOT), bench=str(ROOT / "benchmark"), tiny=TINY,
             cells=CELLS, small=SMALL, config=CONFIG)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307
    assert "sionna_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sionna_tpu"}
