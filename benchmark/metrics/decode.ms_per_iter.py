"""decode.ms_per_iter: mean device milliseconds per MC iteration of the
link's "decode" layer, between the CUDA events the link records at the
start of this layer and of the next (``rec.mark`` in the link).
"""


def read(run):
    times = run.stage_ms.get("decode")
    if not times:
        return None
    return float(sum(times) / len(times))
