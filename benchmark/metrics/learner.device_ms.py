"""Learner: device ms per `update_high_utd` call, of the operations launched
while its span is open (on any host thread, autograd's backward too)."""

SPAN = "bench.learner"


def read(run):
    if not run.ops:  # no device trace
        return None
    calls = run.span_count(SPAN)
    if not calls:
        return None
    return run.device_s(SPAN) / calls * 1e3
