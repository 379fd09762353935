"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet for the H100 SXM part, dense rates, at its 700 W limit): FP32
outside the tensor cores in operations per second (an FMA counts 2) and
HBM bandwidth in bytes per second."""

PEAKS = {
    "H100": {"fp32_ops_s": 67e12, "hbm_bytes_s": 3.35e12},
}


def peaks(device_name):
    """The peaks of the card named ``device_name``; KeyError for a card
    the table does not hold."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peaks for {device_name!r}")
