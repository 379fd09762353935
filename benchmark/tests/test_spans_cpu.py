"""``spans.py`` on the CPU: the busy and idle partition of a recorded
trace with program spans, runtime calls and correlation ids, each
per-iteration metric, and a real CPU trace of ``sim_ber`` under an
active ``Profiler``."""

import json

import pytest
import torch

from spans import SpanTrace, closure, metrics

BASE = 1_000_000_000_000


def _span(name, parent, iteration, a_us, b_us):
    return (name, parent, iteration, BASE + a_us * 1000,
            None if b_us is None else BASE + b_us * 1000)


# two MC iterations in one chunk, 10 ms of window
SPANS = [
    _span("mc_chunk", None, None, 0, 10000),
    _span("sim_ber.iter", 0, 0, 0, 4000),
    _span("Mapper", 1, 0, 500, 1500),
    _span("LDPC5GDecoder", 1, 0, 2000, 3500),
    _span("sim_ber.iter", 0, 1, 4000, 8000),
    _span("Mapper", 4, 1, 4500, 5500),
    _span("LDPC5GDecoder", 4, 1, 6000, 7500),
    _span("sim_ber.readback", 0, None, 8000, 9500),
    _span("sim_ber.bookkeeping", 0, None, 9500, 10000),
]


def _recorded(tmp_path, spans=SPANS):
    ev = []
    for name, _, _, a, b in spans:
        a_us, b_us = (a - BASE) / 1000, (b - BASE) / 1000
        if name == "Mapper":  # a range 2 us wider than its span
            a_us, b_us = a_us - 2, b_us + 2
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": a_us, "dur": b_us - a_us})

    def call(name, ts, corr=None):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                   "ts": ts, "dur": 5.0, "args": {"correlation": corr}})

    def dev(cat, name, ts, dur, corr):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": {"correlation": corr}})

    call("cudaLaunchKernel", 600, 1)
    dev("kernel", "tx_kernel", 1000, 1000, 1)
    call("cudaLaunchKernelExC", 2100, 2)
    dev("kernel", "lifted_bp_kernel", 2200, 2000, 2)
    call("cudaStreamSynchronize", 4100)
    call("cudaLaunchKernel", 4600, 3)
    dev("kernel", "tx_kernel", 4700, 500, 3)
    call("cudaLaunchKernelExC", 6100, 4)
    dev("kernel", "lifted_bp_kernel", 6200, 2000, 4)
    call("cudaMemcpyAsync", 8100, 5)
    dev("gpu_memcpy", "Memcpy DtoH", 8300, 100, 5)
    call("cudaStreamSynchronize", 8150)
    dev("kernel", "launched_before_the_trace", 9000, 200, 99)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE,
                                "traceEvents": ev}))
    return path


def test_partition_of_a_recorded_trace(tmp_path):
    st = SpanTrace(_recorded(tmp_path), SPANS)
    assert st.window_us == 10000 and st.iterations == 2
    busy, idle = st.busy_us(), st.idle_us()
    assert busy == pytest.approx({"tx": 1500, "decode": 4000,
                                  "sim_ber": 100, "unattributed": 200})
    assert idle == pytest.approx({"tx": 1000, "decode": 400,
                                  "sim_ber": 2800})
    # busy and idle close to the window: nothing is lost or counted twice
    assert sum(busy.values()) + sum(idle.values()) == pytest.approx(10000)
    check = closure(st)
    assert check["sum_over_window"] == pytest.approx(1.0)
    assert check["outside_share"] == 0
    assert check["attributed_kernel_share"] == pytest.approx(5500 / 5700)
    assert check["clock_gap_median_us"] == 0
    assert check["clock_gap_max_us"] == pytest.approx(2)


@pytest.mark.parametrize("name,expected", [
    ("tx.busy_ms_per_iter", 0.75), ("tx.idle_ms_per_iter", 0.5),
    ("decode.busy_ms_per_iter", 2.0), ("decode.idle_ms_per_iter", 0.2),
    ("sim_ber.busy_ms_per_iter", 0.05), ("sim_ber.idle_ms_per_iter", 1.4),
    ("channel.busy_ms_per_iter", None), ("estimation.idle_ms_per_iter",
                                         None),
    ("sim_ber.syncs_per_iter", 1.0), ("sim_ber.launches_per_iter", 2.0),
    ("sim_ber.readback_wait_ms", 1.5)])
def test_metric_of_a_recorded_trace(tmp_path, name, expected):
    got = metrics(SpanTrace(_recorded(tmp_path), SPANS))
    if expected is None:
        assert name not in got
    else:
        assert got[name] == pytest.approx(expected)


def test_syncs_name_their_spans(tmp_path):
    st = SpanTrace(_recorded(tmp_path), SPANS)
    assert st.syncs() == [("cudaStreamSynchronize", "sim_ber.iter"),
                          ("cudaStreamSynchronize", "sim_ber.readback")]


def test_open_spans_and_no_spans(tmp_path):
    path = _recorded(tmp_path)
    # the chunk and its bookkeeping still open when the trace ended
    open_ = SPANS[:8] + [_span("sim_ber.bookkeeping", 0, None, 9500,
                               None)]
    open_[0] = _span("mc_chunk", None, None, 0, None)
    st = SpanTrace(path, open_)
    assert closure(st)["outside_share"] == 0
    assert st.idle_us() == pytest.approx({"tx": 1000, "decode": 400,
                                          "sim_ber": 2800})
    # without spans: every device op is outside, no metric is read
    bare = SpanTrace(path, [])
    assert bare.iterations == 0 and metrics(bare) == {}
    assert closure(bare)["outside_share"] == 1.0


def test_cpu_trace_of_sim_ber(tmp_path):
    """A CPU torch.profiler trace around an active Profiler: every
    MC iteration found, the spans on the trace's clock, nothing on the
    device."""
    from sionna_tpu_torch.phy import AWGN, BinarySource, Demapper, Mapper
    from sionna_tpu_torch.phy.utils import Profiler, ebnodb2no, sim_ber
    dev = torch.device("cpu")
    src, mapper = BinarySource(device=dev), Mapper("qam", 2, device=dev)
    demapper, awgn = Demapper("app", "qam", 2, device=dev), AWGN(device=dev)

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, 2, 1.0)
        b = src([batch_size, 32])
        return b, (demapper(awgn(mapper(b), no), no) > 0).float()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with torch.profiler.record_function("first"):
            pass  # the trace's first range opens slower
        with Profiler() as prof:
            sim_ber(mc_fun, [2.0], 8, max_mc_iter=6, device_iters=3,
                    early_stop=False, verbose=False)
    path = tmp_path / "cpu.json"
    tp.export_chrome_trace(str(path))
    st = SpanTrace(path, prof.spans())
    assert st.iterations == 6 and st.device == []
    assert st.readback_wait_ms() > 0
    # AWGN is no listed block: its time is sim_ber's
    assert {s[3] for s in st.spans} == {"tx", "detection", "sim_ber"}
    check = closure(st)
    assert check["clock_gap_median_us"] < 20
    assert check["outside_share"] < 0.5
    assert metrics(st) == {}
