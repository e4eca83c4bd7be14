"""Kernel K5: the least time of the window's Dense + LayerNorm + tanh work
(`rooflines/k5.py`, from the cell's shapes) over the K5 kernels' device time, in %."""

from benchmark.manifest import roofline

KERNEL = "k5"


def read(run):
    k5 = roofline(KERNEL)
    kernel_s = run.device_s(match=k5.matches)
    calls = [c for c in run.calls["iteration"] if c.kind == k5.CALL_KIND]
    if kernel_s <= 0 or not calls or run.iterations <= 0:
        return None
    return 100.0 * run.iterations * sum(k5.least_seconds(c) for c in calls) / kernel_s
