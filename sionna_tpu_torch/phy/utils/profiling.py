"""Profiling utilities (counterpart of
``sionna_tpu/phy/utils/profiling.py``).

``Profiler`` accumulates wall time per named phase and can capture a
``torch.profiler`` trace of its ``with`` block:

    with Profiler(trace_dir="build/trace") as prof:
        with prof.phase("encode"):
            c = enc(u)
        with prof.phase("decode"):
            b = dec(llr)
    print(prof.summary())

Each phase also opens a ``torch.profiler.record_function`` range, so it
shows on the trace's timeline. ``sim_ber(..., profiler=prof)`` records
its chunks as "compile" (the first chunk of each length) and "mc_chunk"
phases.
"""

import os
import time
from contextlib import contextmanager

import torch

__all__ = ["Profiler"]


class Profiler:
    """Named-phase wall-clock profiler with optional trace capture.

    Parameters
    ----------
    trace_dir : str or None
        If set, a ``torch.profiler`` trace (CPU and, when a card is
        present, CUDA activity) is captured for the ``with`` block and
        written there as a Chrome trace (``trace.json``).
    """

    def __init__(self, trace_dir=None):
        self._trace_dir = trace_dir
        self._prof = None
        self._times = {}
        self._counts = {}

    # -- context management -------------------------------------------
    def __enter__(self):
        if self._trace_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof is not None:
            self._prof.__exit__(exc_type, exc, tb)
            os.makedirs(self._trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self._trace_dir, "trace.json"))
            self._prof = None
        return False

    # -- phases --------------------------------------------------------
    @contextmanager
    def phase(self, name):
        """Accumulates wall time under ``name``; nests freely."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            dt = time.perf_counter() - t0
            self._times[name] = self._times.get(name, 0.) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    # -- reporting -----------------------------------------------------
    @property
    def times(self):
        """dict name -> accumulated seconds"""
        return dict(self._times)

    @property
    def counts(self):
        """dict name -> number of phase entries"""
        return dict(self._counts)

    def as_dict(self):
        return {n: {"seconds": self._times[n], "count": self._counts[n]}
                for n in self._times}

    def summary(self):
        """Formatted per-phase table, longest first."""
        if not self._times:
            return "(no phases recorded)"
        width = max(len(n) for n in self._times)
        lines = [f"{'phase':<{width}} | {'count':>6} | "
                 f"{'total [s]':>10} | {'mean [ms]':>10}"]
        lines.append("-" * len(lines[0]))
        for n in sorted(self._times, key=self._times.get, reverse=True):
            t, c = self._times[n], self._counts[n]
            lines.append(f"{n:<{width}} | {c:>6} | {t:>10.3f} | "
                         f"{1e3 * t / c:>10.3f}")
        return "\n".join(lines)

    def reset(self):
        self._times.clear()
        self._counts.clear()
