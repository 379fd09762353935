"""The port's spans (``sionna_tpu_torch.phy.utils.profiling``): a span's
parent, MC iteration and nesting; activation; ``Block`` calls with and
without an active ``Profiler``; ``sim_ber``'s spans and their cover of
the sweep; the spans' clock against a ``torch.profiler`` trace."""

import gc
import json
import time

import numpy as np
import pytest
import torch

from sionna_tpu_torch.phy import AWGN, BinarySource, Block, Demapper, Mapper
from sionna_tpu_torch.phy.config import config as torch_config
from sionna_tpu_torch.phy.utils import (Profiler, ebnodb2no, hard_decisions,
                                       profiling, sim_ber)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _blocks_on_cpu():
    device = torch_config.device
    torch_config.device = "cpu"
    yield
    torch_config.device = device


@pytest.fixture(autouse=True)
def _no_tracer_left_active():
    assert profiling.active is None
    yield
    assert profiling.active is None


class Echo(Block):
    """Returns its (cast) inputs."""

    def forward(self, x, y=None, rest=None):
        return x, y, rest


class Outer(Block):
    """A block that calls two others."""

    def __init__(self):
        super().__init__()
        self.src, self.mapper = BinarySource(), Mapper("qam", 2)

    def forward(self, batch_size):
        return self.mapper(self.src([batch_size, 8]))


def _uncoded_model(nbps=2):
    src, mapper = BinarySource(), Mapper("qam", nbps)
    demapper, awgn = Demapper("app", "qam", nbps), AWGN()

    def mc_fun(batch_size, ebno_db):
        no = ebnodb2no(ebno_db, nbps, 1.0)
        b = src([batch_size, 64])
        llr = demapper(awgn(mapper(b), no), no)
        return b, hard_decisions(llr)

    return mc_fun


def _trace_events(prof, path):
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data, [e for e in data["traceEvents"] if e.get("ph") == "X"]


def test_span_parent_iteration_and_nesting():
    prof = Profiler()
    with prof.phase("outer", iteration=7):
        with prof.phase("mid"):
            with prof.phase("leaf"):
                pass
        with prof.phase("own", iteration=8):
            pass
    with prof.phase("alone"):
        pass
    spans = prof.spans()
    assert [s.name for s in spans] == ["outer", "mid", "leaf", "own",
                                       "alone"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    assert [s.iteration for s in spans] == [7, 7, 7, 8, None]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert spans[2].end_ns <= spans[3].start_ns
    # times and counts are over all spans
    assert prof.counts == {n: 1 for n in ("outer", "mid", "leaf", "own",
                                          "alone")}
    assert prof.times["outer"] == pytest.approx(
        (spans[0].end_ns - spans[0].start_ns) * 1e-9)
    # an open span reads with no end; reset waits for it to close
    prof.open("open")
    assert prof.spans()[-1].end_ns is None and prof.spans()[-1].parent \
        is None
    with pytest.raises(RuntimeError):
        prof.reset()
    prof.close()
    prof.reset()
    assert prof.spans() == [] and prof.counts == {}


def test_activation_nests_and_restores():
    p1, p2 = Profiler(), Profiler()
    with p1 as entered:
        assert entered is p1 and profiling.active is p1
        with p2:
            assert profiling.active is p2
            with p2:
                assert profiling.active is p2
            assert profiling.active is p2
        assert profiling.active is p1
    assert profiling.active is None
    with pytest.raises(ValueError):
        with p1:
            raise ValueError("leaves the block")
    assert profiling.active is None


def test_ranges_only_while_the_torch_profiler_records(tmp_path,
                                                     monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with Profiler() as prof:  # no torch.profiler: spans, no ranges
        Echo()(torch.ones(2))
    assert [s.name for s in prof.spans()] == ["Echo"] and opened == []
    # made inactive while a span is open, a profiler ends its range
    # there: the trace's range stops before the torch.profiler does,
    # the span when its code does
    prof = Profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        prof.__enter__()
        prof.open("left_open")
        prof.__exit__(None, None, None)
        off_ns = time.time_ns()
        time.sleep(0.02)
    prof.close()
    assert opened == ["left_open"]
    data, events = _trace_events(tp, tmp_path / "trace.json")
    (rng,) = [e for e in events if e["name"] == "left_open"]
    end_ns = int(data["baseTimeNanoseconds"]) + round(
        (rng["ts"] + rng["dur"]) * 1e3)
    assert end_ns <= off_ns
    assert prof.spans()[0].end_ns - off_ns > 20_000_000


def test_block_without_tracer_records_nothing_and_casts(tmp_path):
    echo = Echo()
    idle = Profiler()  # made, never activated
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        x, y, rest = echo(torch.ones(3, dtype=torch.float64), y=2.5,
                          rest=[np.ones(2, np.complex128),
                                torch.arange(3)])
    assert idle.spans() == [] and idle.counts == {}
    _, events = _trace_events(tp, tmp_path / "trace.json")
    assert not [e for e in events if e.get("cat") == "user_annotation"]
    assert x.dtype == torch.float32 and torch.equal(x, torch.ones(3))
    assert y.dtype == torch.float32 and float(y) == 2.5
    assert isinstance(rest, list) and rest[0].dtype == torch.complex64
    assert rest[1].dtype == torch.int64
    assert torch.equal(rest[1], torch.arange(3))


def test_block_spans_nest_under_an_active_tracer(tmp_path):
    outer = Outer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with Profiler() as prof:
            with prof.phase("step", iteration=3):
                x = outer(4)
            echo_out = Echo()(torch.zeros(2, dtype=torch.float64))
    assert x.shape == (4, 4) and x.dtype == torch.complex64
    assert echo_out[0].dtype == torch.float32
    spans = prof.spans()
    assert [(s.name, s.parent, s.iteration) for s in spans] == [
        ("step", None, 3), ("Outer", 0, 3), ("BinarySource", 1, 3),
        ("Mapper", 1, 3), ("Echo", None, None)]
    _, events = _trace_events(tp, tmp_path / "trace.json")
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(ranges) == sorted(s.name for s in spans)


def test_sim_ber_spans_cover_the_sweep():
    calls = []
    model = _uncoded_model()

    def mc_fun(batch_size, ebno_db):
        time.sleep(0.02)
        calls.append(ebno_db)
        return model(batch_size, ebno_db)

    def callback(*_):
        time.sleep(0.02)

    prof = Profiler()
    sim_ber(mc_fun, [0.0, 2.0], 32, max_mc_iter=5, device_iters=2,
            early_stop=False, verbose=False, callback=callback,
            profiler=prof)
    assert profiling.active is None
    spans = prof.spans()
    names = [s.name for s in spans]
    # 2 points x 5 iterations, in chunks of 2, 2 and 1
    assert names.count("sim_ber.iter") == len(calls) == 10
    assert names.count("sim_ber.readback") == 6
    assert prof.counts["compile"] == 2 and prof.counts["mc_chunk"] == 4
    assert names.count("sim_ber.bookkeeping") == 6 + 2
    iters = [s for s in spans if s.name == "sim_ber.iter"]
    assert [s.iteration for s in iters] == list(range(10))
    chunks = [i for i, s in enumerate(spans)
              if s.name in ("compile", "mc_chunk")]
    for i, s in enumerate(spans):
        if s.name in ("compile", "mc_chunk"):
            assert s.parent is None
        elif s.name.startswith("sim_ber.") and s.parent is not None:
            assert s.parent in chunks
        if s.name in ("Mapper", "Demapper", "AWGN", "BinarySource"):
            assert spans[s.parent].name == "sim_ber.iter"
            assert s.iteration == spans[s.parent].iteration
    # each chunk holds its iterations, one readback, one bookkeeping
    for c in chunks:
        kids = [s.name for s in spans if s.parent == c]
        assert kids[-2:] == ["sim_ber.readback", "sim_ber.bookkeeping"]
        assert set(kids[:-2]) == {"sim_ber.iter"}
    # no host gap: the top-level spans and each chunk's children tile
    # the sweep; every mc_fun call and callback sleeps 20 ms, so one
    # outside the spans would leave a gap of that size
    top = [s for s in spans if s.parent is None]
    groups = [top] + [[s for s in spans if s.parent == c] for c in chunks]
    for group in groups:
        for a, b in zip(group, group[1:]):
            assert 0 <= b.start_ns - a.end_ns < 5_000_000, (a, b)
    for c in chunks:
        kids = [s for s in spans if s.parent == c]
        assert kids[0].start_ns - spans[c].start_ns < 5_000_000
        assert spans[c].end_ns - kids[-1].end_ns < 5_000_000


def test_sim_ber_records_into_the_active_tracer():
    with Profiler() as prof:
        sim_ber(_uncoded_model(), [1.0], 16, max_mc_iter=2,
                device_iters=1, early_stop=False, verbose=False)
    assert prof.counts["sim_ber.iter"] == 2
    assert prof.counts["Mapper"] == 2
    # with none active and none given, nothing is recorded anywhere
    other = Profiler()
    sim_ber(_uncoded_model(), [1.0], 16, max_mc_iter=2, early_stop=False,
            verbose=False)
    assert other.spans() == [] and prof.counts["sim_ber.iter"] == 2
    # made active in mid-sweep (by the callback after the first chunk):
    # the next chunks' spans, and no others
    late = Profiler()
    state = {}

    def callback(*_):
        if not state:
            state["on"] = late.__enter__()
        elif len(state) == 1:
            state["off"] = late.__exit__(None, None, None)

    sim_ber(_uncoded_model(), [1.0], 16, max_mc_iter=6, device_iters=2,
            early_stop=False, verbose=False, callback=callback)
    assert late.counts["sim_ber.iter"] == 2
    assert late.counts["mc_chunk"] == 1 and "compile" not in late.counts
    iters = [s for s in late.spans() if s.name == "sim_ber.iter"]
    assert [s.iteration for s in iters] == [2, 3]


def _clock_gaps_ns(path):
    """A CPU torch.profiler trace of a short sweep under an active
    Profiler: |start| and |end| differences between each span and its
    record_function range, mapped to ns with baseTimeNanoseconds."""
    gc.disable()  # a collection between a range's start and its span's
    try:          # would read as a gap of the clocks
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
            with torch.profiler.record_function("first"):
                pass  # the trace's first range opens slower
            with Profiler() as prof:
                sim_ber(_uncoded_model(), [1.0], 16, max_mc_iter=4,
                        device_iters=2, early_stop=False, verbose=False)
    finally:
        gc.enable()
    data, events = _trace_events(tp, path)
    base = int(data["baseTimeNanoseconds"])
    ranges = {}
    for e in sorted((e for e in events
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        start = base + round(e["ts"] * 1e3)
        ranges.setdefault(e["name"], []).append(
            (start, start + round(e["dur"] * 1e3)))
    spans = prof.spans()
    assert len(spans) > 20
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    gaps = []
    for name, group in by_name.items():
        assert len(ranges[name]) == len(group), name
        for s, (a, b) in zip(group, ranges[name]):
            gaps += [abs(s.start_ns - a), abs(s.end_ns - b)]
    return gaps


def test_span_clock_matches_the_profiler_trace(tmp_path):
    """Each span's record_function range in a CPU torch.profiler trace,
    mapped to ns with the trace's baseTimeNanoseconds, lies within 50 us
    of the span in memory. A span's clock reading and its range's are
    taken microseconds apart in one thread, so a host that deschedules
    the thread between them (a shared CPU does, now and then) shows one
    wider gap: the sweep is traced anew, up to three times, until one
    trace holds every span within 50 us. A wrong clock or unit fails
    every trace."""
    tries = []
    for k in range(3):
        gaps = _clock_gaps_ns(tmp_path / f"trace{k}.json")
        tries.append(max(gaps))
        if max(gaps) < 50_000:
            break
    assert min(tries) < 50_000, tries
