"""The comparison that decides ``correct``: gaps between what the
program produced and what the plain reference computes from the same
inputs, and the rounding that makes the lower-precision control."""

import torch


def identity(t):
    return t


def bf16(t):
    """``t`` rounded to bfloat16 and back (real and imaginary parts of a
    complex tensor apart): the control's precision below float32."""
    if t.is_complex():
        return torch.complex(t.real.to(torch.bfloat16).to(t.real.dtype),
                             t.imag.to(torch.bfloat16).to(t.imag.dtype))
    if t.is_floating_point():
        return t.to(torch.bfloat16).to(t.dtype)
    return t


class Gap:
    """Widest gap of a program's values to the reference's, as a share of
    the reference's largest magnitude, accumulated over blocks."""

    def __init__(self):
        self.diff = 0.0
        self.scale = 0.0

    def add(self, program, reference):
        program = program.to(reference.dtype)
        self.diff = max(self.diff, float(torch.max(torch.abs(
            program - reference))))
        self.scale = max(self.scale, float(torch.max(torch.abs(reference))))

    @property
    def value(self):
        return self.diff / self.scale if self.scale > 0 else float("inf")


def judge(readings, limits):
    """(correct, rows): each reading beside its limit; a reading above
    its limit, not finite, or without a limit makes the run incorrect."""
    rows = {}
    ok = True
    for name, value in readings.items():
        limit = limits.get(name)
        good = (limit is not None and value == value
                and value != float("inf") and value <= limit)
        ok = ok and good
        rows[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(readings)
    for name in sorted(missing):
        rows[name] = {"value": None, "limit": limits[name]}
        ok = False
    return ok, rows
