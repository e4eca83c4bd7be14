"""Encoders (convolutions): device ms per `update_high_utd` call of the
convolution kernels (`rooflines/conv.py`'s names) launched while the
learner's span is open; `learner.device_ms` less this is the GroupNorm,
cast, pad, pool and head work around them."""

from benchmark.manifest import roofline

SPAN = "bench.learner"


def read(run):
    if not run.ops:  # no device trace
        return None
    calls = run.span_count(SPAN)
    kernel_s = run.device_s(SPAN, match=roofline("conv").matches)
    if not calls or kernel_s <= 0:
        return None
    return kernel_s / calls * 1e3
