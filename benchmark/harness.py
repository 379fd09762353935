"""The benchmark of ``sionna_tpu_torch``: one cell, one run.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>
.json`` with its builder and reference pieces in ``configs/<config>.py``)
and a traffic mix (``workloads/<cell>.json``). A run:

1. seeds the port (``config.seed``), builds the cell's link from the
   port's public blocks and warms it up with one ``sim_ber`` chunk of
   the cell's own shapes (set-up, timed from the process's start);
2. drives ``sim_ber`` at the cell's one Eb/No point and batch for
   ``--seconds`` (``early_stop=False``, a callback that stops it at the
   first chunk end past the time); the window ends at the last chunk's
   counter readback;
3. with ``--trace 1``, marks each layer of every MC iteration with CUDA
   events and traces a steady stretch of chunks with ``torch.profiler``,
   and the per-layer readers of ``metrics/`` reduce both;
4. once the window has closed, the memory peak read and the link freed,
   compares a sample of the window's MC iterations, drawn from the seed
   (reservoir sampling over all of them), with the configuration's plain
   reference, each reading against the cell's limit.

It prints one JSON line last on standard output, and the readings with
their limits last on standard error.
"""

import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = ("jax", "jaxlib", "flax", "sionna_tpu")


def load_module(path, name):
    """The Python file ``path`` imported as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules():
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


class Cell:
    """A cell of ``BENCHMARK.json`` and what the harness finds by its
    names: the configuration, its module, the traffic and the per-layer
    readers that apply to it."""

    def __init__(self, name, overrides=None, config_overrides=None):
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_name = self.entry["config"]
        self.cfg = json.loads((ROOT / configs[self.config_name]["file"])
                              .read_text())
        self.module = load_module(
            BENCH_DIR / "configs" / f"{self.config_name}.py",
            f"bench_config_{self.config_name}")
        self.traffic = json.loads(
            (BENCH_DIR / "workloads" / f"{name}.json").read_text())
        self.traffic.update(overrides or {})
        for key, value in (config_overrides or {}).items():
            if isinstance(value, dict):
                self.cfg[key] = {**self.cfg[key], **value}
            else:
                self.cfg[key] = value
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]

    def readers(self):
        """{metric name: its reader module} for this cell."""
        return {m["name"]: load_module(BENCH_DIR / "metrics"
                                       / f"{m['name']}.py",
                                       "bench_metric_" + m["name"]
                                       .replace(".", "_"))
                for m in self.per_layer}


class Recorder:
    """What the link hands the harness: layer marks (CUDA events, and
    profiler ranges while a trace runs) and the tensors the check
    compares. Disarmed, both are no-ops."""

    def __init__(self):
        self.timing = False
        self.ranges = False
        self.slot = None
        self.iters = []
        self._marks = None
        self._range = None

    def begin(self):
        if self.timing:
            self._marks = []

    def mark(self, name):
        if self.timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((name, ev))
        if self.ranges:
            self._close_range()
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()

    def end(self):
        if self.timing:
            self.mark("end")
            self.iters.append(self._marks)
        self._close_range()

    def _close_range(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def keep(self, **tensors):
        if self.slot is not None:
            self.slot.update(tensors)

    def keeping(self, model):
        """``model`` (a channel model: a callable returning (a, tau),
        not a module, so no hook takes) handing each draw to ``keep``."""
        return _KeptDraws(model, self)

    def layer_ms(self):
        """(per-iteration ms, {layer: per-iteration ms}) from the marks,
        the device's clock; read after a synchronize."""
        stages, iters = {}, []
        for i, marks in enumerate(self.iters):
            for (name, a), (_, b) in zip(marks, marks[1:]):
                stages.setdefault(name, []).append(a.elapsed_time(b))
            nxt = self.iters[i + 1][0][1] if i + 1 < len(self.iters) \
                else marks[-1][1]
            iters.append(marks[0][1].elapsed_time(nxt))
        return iters, stages


class _KeptDraws:
    """A channel model that hands each draw (a, tau) to a recorder."""

    def __init__(self, model, rec):
        self._model, self._rec = model, rec

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, *args, **kwargs):
        a, tau = self._model(*args, **kwargs)
        self._rec.keep(a=a, tau=tau)
        return a, tau


class MonteCarlo:
    """The ``sim_ber`` model around the link: counts the iterations and
    info bits, flags malformed outputs on the device (read after the
    window), and keeps a reservoir sample of iterations for the check."""

    def __init__(self, link, rec, capture, seed):
        self.link, self.rec = link, rec
        self.capture = capture
        self.rng = random.Random(seed)
        self.kept = []
        self.iters = 0
        self.bits = 0
        self.failed = 0
        self.errors = []
        self.bad = None
        self.sampling = False

    def __call__(self, batch_size, ebno_db):
        slot = {} if self.sampling else None
        self.rec.slot = slot
        self.rec.begin()
        try:
            b, b_hat = self.link(batch_size, ebno_db)
        except Exception as exc:  # pylint: disable=broad-except
            # the iteration failed: counted, and the run goes on
            self.failed += 1
            self.errors.append(repr(exc)[:500])
            self.rec.slot = None
            self.rec.end()
            z = torch.zeros((batch_size, 1))
            return z, z
        self.rec.end()
        self.rec.slot = None
        if b_hat.shape != b.shape:
            self.failed += 1
        else:
            flag = ((b_hat != 0) & (b_hat != 1)).any().to(torch.int64)
            self.bad = flag if self.bad is None else self.bad + flag
        if slot is not None:
            slot["b"], slot["b_hat"] = b, b_hat
            if len(self.kept) < self.capture:
                self.kept.append(slot)
            else:
                j = self.rng.randrange(self.iters + 1)
                if j < self.capture:
                    self.kept[j] = slot
        self.iters += 1
        self.bits += b.numel()
        return b, b_hat


class Trace:
    """A ``torch.profiler`` chrome trace reduced to device intervals,
    kernels and host ranges."""

    DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
    HOST = ("cpu_op", "user_annotation", "cuda_runtime")

    def __init__(self, path):
        events = [e for e in json.loads(Path(path).read_text())
                  .get("traceEvents", []) if e.get("ph") == "X"]
        self.device = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                       for e in events if e.get("cat") in self.DEVICE]
        self.kernel_list = [(e["name"], e.get("dur", 0) * 1e-6)
                            for e in events if e.get("cat") == "kernel"]
        self.host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                      e.get("cat")) for e in events
                     if e.get("cat") in self.HOST]
        ends = [t for ev in self.host + self.device for t in ev[:2]]
        self.t0, self.t1 = (min(ends), max(ends)) if ends else (0.0, 0.0)
        self.merged = []
        for a, b, _ in sorted(self.device):
            a, b = max(a, self.t0), min(b, self.t1)
            if self.merged and a <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], b)
            elif b > a:
                self.merged.append([a, b])

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.merged) * 1e-6

    def kernels(self, fragment):
        """Device seconds of each launch of kernels whose name holds
        ``fragment``."""
        return [d for name, d in self.kernel_list if fragment in name]

    def device_ops(self, top=10):
        tot = {}
        for a, b, name in self.device:
            tot[name[:160]] = tot.get(name[:160], 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The longest idle stretches of the device, each named by the
        innermost host range open at its middle."""
        edges = [self.t0] + [t for m in self.merged for t in m] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inner = [h for h in self.host if h[0] <= mid <= h[1]]
            label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
                else "host outside any traced range"
            out.append([label[:160], (b - a) * 1e-6])
        return out


class RunRecord:
    """What a per-layer reader reads: the layers' CUDA-event times, the
    trace, the memory peak of the window, the decoders' work per launch
    and the card's peaks."""

    def __init__(self, iter_ms, stage_ms, trace, peak_window_bytes, work,
                 peaks):
        self.iter_ms = iter_ms
        self.stage_ms = stage_ms
        self.trace = trace
        self.peak_window_bytes = peak_window_bytes
        self.work = work
        self.peaks = peaks

    def roofline(self, key, fragment):
        """Percent of its roofline that the traced launches of the kernel
        whose name holds ``fragment`` reach, with the work per launch
        ``self.work[key]``; None where nothing was traced."""
        if self.trace is None or self.peaks is None or key not in self.work:
            return None
        times = self.trace.kernels(fragment)
        if not times or sum(times) <= 0:
            return None
        w = self.work[key]
        least = max(w["bytes"] / self.peaks["hbm_bytes_s"],
                    w["flops"] / self.peaks["fp32_ops_s"])
        return 100.0 * least * len(times) / sum(times)


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(workload, seed, seconds, trace, t0, device="cuda",
        overrides=None, plant=None, control=False, config_overrides=None):
    """One run of ``workload``; returns the result dict and the readings'
    rows. ``device="cpu"`` rehearses it without a card (no CUDA events,
    no device trace); ``plant(link)``, if given, breaks the timed path
    after the link is built (the fault tests); ``control`` adds, under
    the result's key "control", the readings of the reference put in the
    program's place in bfloat16 on the same sampled inputs;
    ``config_overrides`` shrink a configuration for a CPU rehearsal."""
    from sionna_tpu_torch.phy import config
    from sionna_tpu_torch.phy.utils import sim_ber
    from reference.compare import bf16, judge
    from reference.peaks import peaks as card_peaks

    cell = Cell(workload, overrides, config_overrides)
    tr = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config.device = dev
    config.seed = seed
    rec = Recorder()
    link = cell.module.build(cell.cfg, tr, dev, rec)
    if plant is not None:
        plant(link)
    mc = MonteCarlo(link, rec, tr["capture"], seed)
    ebno, batch, chunk = tr["ebno_db"], tr["batch_size"], tr["device_iters"]

    def drive(max_iter, callback=None):
        sim_ber(mc, [ebno], batch, max_mc_iter=max_iter, early_stop=False,
                verbose=False, device_iters=chunk, callback=callback)

    # set-up: one chunk of the cell's shapes, then the profiler's own
    drive(chunk)
    if cuda:
        torch.cuda.synchronize()
    prof_kw = {"activities": [torch.profiler.ProfilerActivity.CPU]
               + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])}
    if trace:
        with torch.profiler.profile(**prof_kw):
            torch.ones(8, device=dev).add_(1)
            if cuda:
                torch.cuda.synchronize()
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mc.iters = mc.bits = mc.failed = 0
    mc.bad = None
    mc.sampling = True
    rec.timing = bool(trace) and cuda
    first, last = tr["trace_chunks"]
    state = {"chunks": 0, "prof": None, "end": None, "marks": []}

    def stop_profiler():
        if state["prof"] is not None:
            state["prof"].stop()
            rec.ranges = False

    def callback(*_):
        state["chunks"] += 1
        state["marks"].append(time.perf_counter())
        if trace and state["chunks"] == first:
            state["prof"] = torch.profiler.profile(**prof_kw)
            state["prof"].start()
            rec.ranges = True
        elif trace and state["chunks"] == last:
            stop_profiler()
        if time.perf_counter() - t_start >= seconds:
            state["end"] = time.perf_counter()
            return True
        return None

    t_start = time.perf_counter()
    setup_s = t_start - t0
    drive(tr["max_mc_iter"], callback)
    window_s = state["end"] - t_start
    chunk_s = np.diff([t_start] + state["marks"])
    if trace and state["chunks"] < last:
        stop_profiler()
    rec.timing = False
    # after the window: the peak, the layers' times, the trace
    if cuda:
        torch.cuda.synchronize()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    bad = int(mc.bad) if mc.bad is not None else 0
    failed = mc.failed + bad
    metrics = {}
    result = {"correct": False, "attempted": mc.iters, "failed": failed}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": int(max(peak_setup, peak_window))}
    breakdown = None
    if trace:
        iter_ms, stage_ms = rec.layer_ms() if cuda else ([], {})
        tr_obj = None
        if state["prof"] is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                state["prof"].export_chrome_trace(path)
                tr_obj = Trace(path)
            finally:
                os.unlink(path)
        record = RunRecord(
            iter_ms, stage_ms, tr_obj, peak_window,
            cell.module.work(cell.cfg, tr),
            card_peaks(dev_info["kind"]) if cuda else None)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, reader in cell.readers().items():
            value = reader.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        if tr_obj is not None:
            dev_info["busy_s"] = tr_obj.busy_s
            dev_info["window_s"] = tr_obj.window_s
            breakdown = {"device_ops": tr_obj.device_ops(),
                         "idle_gaps": tr_obj.idle_gaps()}
        del record, tr_obj
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics["info_bit_throughput"] = {
            "value": mc.bits / window_s / 1e6,
            "unit": units["info_bit_throughput"]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    # the check, with the program's state freed
    kept, errors = mc.kept, mc.errors
    del link, mc, rec, state
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = cell.module.reference(cell.cfg, tr)
    readings = {}
    with torch.no_grad():
        for sample in kept:
            for k, v in ref.readings(sample).items():
                readings[k] = max(readings.get(k, 0), v) \
                    if k != "decode_cw_diff" else readings.get(k, 0) + v
    ok, rows = judge(readings, tr["limits"])
    if control:
        ctrl = {}
        with torch.no_grad():
            for sample in kept:
                low = ref.control(sample, bf16, torch.bfloat16)
                for k, v in ref.readings(low).items():
                    ctrl[k] = max(ctrl.get(k, 0), v) \
                        if k != "decode_cw_diff" else ctrl.get(k, 0) + v
                del low
        result["control"] = ctrl
    if not kept:
        ok = False
    ref_s = time.perf_counter() - t_ref
    result["correct"] = bool(ok and failed == 0)
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = {"power_limit_w": power_limit_w() if cuda else None,
                      "check_s": ref_s, "window_s": window_s,
                      "chunk_s_quartiles": [float(v) for v in np.percentile(
                          chunk_s, [0, 25, 50, 75, 100])],
                      "checked_iterations": len(kept),
                      "errors": errors[:3]}
    result["checks"] = rows
    return result, rows


def main(argv, t0):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = Cell(args.workload).entry["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    result, rows = run(args.workload, args.seed, args.seconds, args.trace,
                       t0)
    found = banned_modules()
    if found:
        print(f"the run loaded {found}: the port and the benchmark may "
              "not import JAX or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, row in rows.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    return 0
