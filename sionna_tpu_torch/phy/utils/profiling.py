"""Profiling utilities (counterpart of
``sionna_tpu/phy/utils/profiling.py``): spans of the program's layers,
kept in memory.

A ``Profiler`` records spans: a name, the span it was opened in (its
parent), the MC iteration it belongs to, and its start and end. While a
profiler is *active*, every ``Block`` call opens a span named after the
block's class, and ``sim_ber`` opens spans for its chunks, its MC
iterations, its counter readbacks and its bookkeeping (see its
docstring). ``with Profiler() as prof:`` makes ``prof`` the process's
active profiler for the block, ``sim_ber(..., profiler=prof)`` for the
sweep; with none active, blocks and ``sim_ber`` record nothing and pay
one check of the module-level variable ``active``. ``prof.phase(name)``
opens a span of the caller's own, active or not:

    with Profiler() as prof:
        with prof.phase("encode"):
            c = enc(u)            # an "LDPC5GEncoder" span inside "encode"
        b = dec(llr)              # an "LDPC5GDecoder" span
    print(prof.summary())         # time and count per span name
    prof.spans()                  # every span, in the order opened

While a ``torch.profiler`` records, each span also opens a
``torch.profiler.record_function`` range of its name, so a
``torch.profiler`` run around an active profiler shows the spans on its
timeline (a range costs some 10 us; with no profiler recording, a span
costs one check of ``torch._C._autograd._profiler_enabled()`` instead,
and a range opened then would not show anyway). A profiler made inactive
ends the ranges of its spans still open, so that a ``torch.profiler``
stopped after it finds none open (an open range would run to the
profiler's stop and lengthen its trace); the spans themselves end when
their code does. There is no exporter of its own: the spans stay in
memory until read.

**The clock.** Starts and ends are ``time.time_ns()``. A
``torch.profiler`` chrome trace gives each event's ``ts`` in
microseconds from the trace's ``baseTimeNanoseconds``, and
``ts * 1e3 + baseTimeNanoseconds`` is the same clock, so a span maps
onto the device trace by that rule alone: a span starts just after its
range opens and ends just after it closes, microseconds apart (the
first range of a process or of a trace opens slower). Spans are
recorded from one thread.
"""

import time
from collections import namedtuple
from contextlib import contextmanager

import torch

__all__ = ["Profiler", "Span"]

# The process's active Profiler, or None (read by ``Block.__call__`` and
# ``sim_ber``; set by ``Profiler.__enter__`` and ``__exit__``).
active = None

Span = namedtuple("Span", "name parent iteration start_ns end_ns")
Span.__doc__ = """A recorded span. ``parent`` is the index of the span it
was opened in (in ``Profiler.spans()``) or None; ``iteration`` the MC
iteration it belongs to (``sim_ber``'s index of the ``mc_fun`` call,
inherited from the parent) or None; ``start_ns`` and ``end_ns`` are
``time.time_ns()`` (``end_ns`` None while the span is open)."""


class Profiler:
    """Spans of the program's layers, with time and count per name."""

    def __init__(self):
        self._spans = []    # [name, parent, iteration, start, end]
        self._open = []     # (index, record_function) of the open spans
        self._times = {}
        self._counts = {}
        self._outer = []    # the profilers active before each __enter__

    # -- activation ----------------------------------------------------
    def __enter__(self):
        global active
        self._outer.append(active)
        active = self
        return self

    def __exit__(self, exc_type, exc, tb):
        global active
        active = self._outer.pop()
        if active is not self:
            for k in range(len(self._open) - 1, -1, -1):
                index, rf = self._open[k]
                if rf is not None:
                    rf.__exit__(None, None, None)
                    self._open[k] = (index, None)
        return False

    # -- spans ---------------------------------------------------------
    def open(self, name, iteration=None):
        """Opens a span ``name`` inside the innermost open one; it
        belongs to MC iteration ``iteration``, by default its parent's.
        Close it with :meth:`close`, innermost first."""
        parent = self._open[-1][0] if self._open else None
        if iteration is None and parent is not None:
            iteration = self._spans[parent][2]
        rf = None
        if torch._C._autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        self._open.append((len(self._spans), rf))
        self._spans.append([name, parent, iteration, time.time_ns(), None])

    def close(self):
        """Closes the innermost open span."""
        index, rf = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        end = time.time_ns()
        rec = self._spans[index]
        rec[4] = end
        name = rec[0]
        self._times[name] = self._times.get(name, 0.) + (end - rec[3]) * 1e-9
        self._counts[name] = self._counts.get(name, 0) + 1

    @contextmanager
    def phase(self, name, iteration=None):
        """A span ``name`` around the ``with`` block; nests freely."""
        self.open(name, iteration)
        try:
            yield self
        finally:
            self.close()

    def spans(self):
        """Every span recorded, as :class:`Span`, in the order opened."""
        return [Span(*rec) for rec in self._spans]

    # -- reporting -----------------------------------------------------
    @property
    def times(self):
        """dict name -> accumulated seconds of the closed spans"""
        return dict(self._times)

    @property
    def counts(self):
        """dict name -> number of closed spans"""
        return dict(self._counts)

    def as_dict(self):
        return {n: {"seconds": self._times[n], "count": self._counts[n]}
                for n in self._times}

    def summary(self):
        """Formatted per-name table, longest first."""
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
        """Forgets every span; not while one is open."""
        if self._open:
            raise RuntimeError("reset() inside an open span")
        self._spans.clear()
        self._times.clear()
        self._counts.clear()
