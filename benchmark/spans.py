"""The program's spans on a ``torch.profiler`` trace: busy and idle
device time of each layer, host syncs, launches and the counter
readback's wait per MC iteration.

Input: a chrome trace of a stretch of ``sim_ber`` taken with CPU and
CUDA activity, and the spans that an active
``sionna_tpu_torch.phy.utils.Profiler`` recorded over it
(``Profiler.spans()``: name, parent, iteration, start and end in
``time.time_ns()``). A span's time maps onto the trace as
``(ns - baseTimeNanoseconds) / 1e3`` microseconds, the trace's own rule.

Each span gets a layer: that of the innermost span, itself or an
enclosing one, whose name ``LAYERS`` lists (block class -> layer); else
"sim_ber" if it lies in a ``sim_ber`` span (a chunk, an iteration, a
readback or bookkeeping); else "other". Host time in no span is
"outside". Over the stretch (the trace's window, as ``harness.Trace``
takes it, so its idle time is ``device.idle_pct``'s):

- *busy*: each kernel, copy and memset goes to the layer of the span
  open at the host time of the runtime call that launched it, found by
  the trace's correlation id ("unattributed" without one);
- *idle*: each idle stretch of the card (the complement of the union of
  the device intervals) is split among the layers of the innermost
  spans open on the host over it, by overlap;
- per MC iteration: divided by the number of "sim_ber.iter" spans whose
  midpoint lies in the stretch.

On one stream the device intervals do not overlap, and busy plus idle
over every layer (with "outside" and "unattributed") is the stretch.
Imports nothing of the program."""

import json
import statistics
from bisect import bisect_right
from pathlib import Path

import harness

LAYERS = {
    # transmitter
    "BinarySource": "tx", "LDPC5GEncoder": "tx",
    "RowColumnInterleaver": "tx", "Mapper": "tx",
    "ResourceGridMapper": "tx", "PUSCHTransmitter": "tx",
    # channel (the TDL and CDL draws are no blocks: inside OFDMChannel)
    "OFDMChannel": "channel",
    # estimation
    "LSChannelEstimator": "estimation",
    "PUSCHLSChannelEstimator": "estimation",
    # detection (PUSCHReceiver's own code too, so perfect CSI's
    # precoding of h)
    "LMMSEEqualizer": "detection", "Demapper": "detection",
    "Deinterleaver": "detection", "LinearDetector": "detection",
    "LayerDemapper": "detection", "PUSCHReceiver": "detection",
    # decode
    "LDPC5GDecoder": "decode", "TBDecoder": "decode",
}
SIM_BER = ("compile", "mc_chunk", "sim_ber.iter", "sim_ber.readback",
           "sim_ber.bookkeeping")
# CUDA API calls that block the host until the card is done
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
         "cuCtxSynchronize", "cuEventSynchronize")
RUNTIME = ("cuda_runtime", "cuda_driver")


class SpanTrace:
    """A traced stretch of ``sim_ber`` attributed to the layers of the
    program's spans; times in microseconds of the trace."""

    def __init__(self, path, spans):
        data = json.loads(Path(path).read_text())
        trace = harness.Trace(path)
        self.t0, self.t1 = trace.t0, trace.t1
        self.merged = trace.merged
        base = int(data["baseTimeNanoseconds"])
        events = [e for e in data.get("traceEvents", [])
                  if e.get("ph") == "X"]
        self._init_spans(spans, base)
        corr = {}
        self.runtime = []
        for e in events:
            if e.get("cat") in RUNTIME:
                self.runtime.append(e)
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    corr[c] = e
        self.device = []   # (start, end, name, cat, launching call)
        for e in events:
            if e.get("cat") in harness.Trace.DEVICE:
                a = max(e["ts"], self.t0)
                b = min(e["ts"] + e.get("dur", 0), self.t1)
                if b > a:
                    call = corr.get((e.get("args") or {}).get("correlation"))
                    self.device.append((a, b, e["name"], e["cat"], call))
        self.ranges = {}   # the spans' record_function ranges, by name
        for e in sorted((e for e in events
                         if e.get("cat") == "user_annotation"),
                        key=lambda e: e["ts"]):
            self.ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
        self._range_starts = {k: [r[0] for r in v]
                              for k, v in self.ranges.items()}

    def _init_spans(self, spans, base):
        """Each span as (start, end, name, layer, parent, in an
        iteration); one still open when the trace ended is open to its
        end. Parents come before their children."""
        self.spans = []
        for name, parent, _, start, end in spans:
            up = self.spans[parent] if parent is not None else None
            if name in LAYERS:
                layer = LAYERS[name]
            elif name in SIM_BER:
                layer = "sim_ber"
            else:
                layer = up[3] if up is not None else "other"
            start = (start - base) / 1e3
            end = max(self.t1, start) if end is None else (end - base) / 1e3
            self.spans.append((start, end, name, layer,
                               parent, name == "sim_ber.iter"
                               or (up is not None and up[5])))
        depth = []
        for sp in self.spans:
            depth.append(0 if sp[4] is None else depth[sp[4]] + 1)
        # by start, parents before children on ties
        self._order = sorted(range(len(self.spans)),
                             key=lambda k: (self.spans[k][0], depth[k]))
        self._starts = [self.spans[k][0] for k in self._order]

    def span_at(self, t):
        """Index of the innermost span open at host time ``t``, or None
        (spans of one thread nest, so it encloses the last one opened
        at or before ``t``)."""
        j = bisect_right(self._starts, t) - 1
        k = self._order[j] if j >= 0 else None
        while k is not None and self.spans[k][1] < t:
            k = self.spans[k][4]
        return k

    def layer_at(self, t):
        k = self.span_at(t)
        return "outside" if k is None else self.spans[k][3]

    def in_window(self, name):
        """The spans called ``name`` whose midpoint lies in the stretch."""
        return [s for s in self.spans if s[2] == name
                and self.t0 <= (s[0] + s[1]) / 2 <= self.t1]

    @property
    def iterations(self):
        return len(self.in_window("sim_ber.iter"))

    @property
    def window_us(self):
        return self.t1 - self.t0

    def busy_us(self):
        """{layer: device microseconds launched from it}."""
        out = {}
        for a, b, _, _, call in self.device:
            layer = "unattributed" if call is None \
                else self.layer_at(call["ts"])
            out[layer] = out.get(layer, 0.0) + (b - a)
        return out

    def segments(self):
        """The stretch cut at the spans' starts and ends: (start, end,
        layer of the innermost span open over it)."""
        cuts = sorted({self.t0, self.t1} | {
            t for s in self.spans for t in s[:2] if self.t0 < t < self.t1})
        return [(a, b, self.layer_at((a + b) / 2))
                for a, b in zip(cuts, cuts[1:])]

    def idle_us(self):
        """{layer: idle microseconds of the card while the host was in
        the layer's spans}."""
        edges = [self.t0] + [t for m in self.merged for t in m] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        segs = self.segments()
        out, j = {}, 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
                if hi > lo:
                    out[segs[k][2]] = out.get(segs[k][2], 0.0) + hi - lo
                k += 1
        return out

    def syncs(self):
        """The host-blocking calls of the stretch inside ``sim_ber``
        spans, each as (call name, innermost span's name)."""
        out = []
        for e in self.runtime:
            if e["name"] in SYNCS and self.t0 <= e["ts"] <= self.t1:
                k = self.span_at(e["ts"])
                if k is not None and self._under_sim_ber(k):
                    out.append((e["name"], self.spans[k][2]))
        return out

    def _under_sim_ber(self, k):
        while k is not None:
            if self.spans[k][2] in SIM_BER:
                return True
            k = self.spans[k][4]
        return False

    def launches(self):
        """Kernel launches of the stretch inside "sim_ber.iter" spans."""
        n = 0
        for _, _, _, cat, call in self.device:
            if cat == "kernel" and call is not None \
                    and self.t0 <= call["ts"] <= self.t1:
                k = self.span_at(call["ts"])
                n += k is not None and self.spans[k][5]
        return n

    def readback_wait_ms(self):
        """Mean duration of the stretch's "sim_ber.readback" spans."""
        spans = self.in_window("sim_ber.readback")
        if not spans:
            return None
        return sum(s[1] - s[0] for s in spans) / len(spans) / 1e3

    def attributed_kernel_share(self):
        """Share of the stretch's kernel time whose launch lies in some
        span, found by correlation id."""
        total = hit = 0.0
        for a, b, _, cat, call in self.device:
            if cat == "kernel":
                total += b - a
                if call is not None and self.span_at(call["ts"]) is not None:
                    hit += b - a
        return hit / total if total else None

    def clock_gaps_us(self):
        """|start| and |end| differences, in microseconds, between each
        span that lies in the stretch and the ``record_function`` range
        of its name that starts nearest to it."""
        gaps = []
        for start, end, name, *_ in self.spans:
            ranges = self.ranges.get(name)
            if not ranges or start < self.t0 or end > self.t1:
                continue
            j = bisect_right(self._range_starts[name], start)
            a, b = min(ranges[max(j - 1, 0):j + 1],
                       key=lambda r: abs(r[0] - start))
            gaps += [abs(start - a), abs(end - b)]
        return gaps


def metrics(st):
    """The per-layer metrics of a ``SpanTrace``, by name; a layer with
    no span in the stretch is left out."""
    n = st.iterations
    if n == 0 or not st.device:
        return {}
    busy, idle = st.busy_us(), st.idle_us()
    present = {s[3] for s in st.spans}
    out = {}
    for layer in ("tx", "channel", "estimation", "detection", "decode",
                  "sim_ber"):
        if layer in present:
            out[f"{layer}.busy_ms_per_iter"] = busy.get(layer, 0.0) / 1e3 / n
            out[f"{layer}.idle_ms_per_iter"] = idle.get(layer, 0.0) / 1e3 / n
    out["sim_ber.syncs_per_iter"] = len(st.syncs()) / n
    out["sim_ber.launches_per_iter"] = st.launches() / n
    wait = st.readback_wait_ms()
    if wait is not None:
        out["sim_ber.readback_wait_ms"] = wait
    return out


def closure(st):
    """Checks of the partition: busy plus idle over all layers against
    the stretch, the share of the stretch's host time in no span, the
    share of kernel time attributed by correlation id, and the clock
    gaps' median and largest (us)."""
    busy, idle = st.busy_us(), st.idle_us()
    outside = sum(b - a for a, b, layer in st.segments()
                  if layer == "outside")
    gaps = st.clock_gaps_us()
    return {"sum_over_window": (sum(busy.values()) + sum(idle.values()))
            / st.window_us,
            "outside_share": outside / st.window_us,
            "attributed_kernel_share": st.attributed_kernel_share(),
            "clock_gap_median_us": statistics.median(gaps) if gaps
            else None,
            "clock_gap_max_us": max(gaps) if gaps else None}
