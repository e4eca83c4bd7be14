"""Encoders (convolutions): the least time of the window's convolution work at
the bf16 dense peak (`rooflines/conv.py`, from the cell's shapes) over the
device time of the convolution kernels, in %."""

from benchmark.manifest import roofline

KERNEL = "conv"


def read(run):
    conv = roofline(KERNEL)
    kernel_s = run.device_s(match=conv.matches)
    calls = [c for c in run.calls["iteration"] if c.kind == conv.CALL_KIND]
    if kernel_s <= 0 or not calls or run.iterations <= 0:
        return None
    return 100.0 * run.iterations * sum(conv.least_seconds(c) for c in calls) / kernel_s
