"""Whole step: the benchmark's own FLOP count of the window's iterations
(`flops/<config>.py`) over the window's seconds at the H100 SXM's bf16
dense peak, in %."""

from benchmark import peaks
from benchmark.counting import total_flops


def read(run):
    if not run.ops:  # no device trace
        return None
    per_iteration = total_flops(run.calls["iteration"])
    if run.iterations <= 0 or per_iteration <= 0 or run.window_s <= 0:
        return None
    return 100.0 * run.iterations * per_iteration / (run.window_s * peaks.BF16_FLOPS)
