"""device.idle_pct: the share of the traced stretch of the window (a
few steady chunks under ``torch.profiler``) in which no kernel, copy or
memset ran on the card: the union of the device intervals, so overlap
counts once."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
