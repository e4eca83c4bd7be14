"""Replay: device ms per loop iteration of the operations launched in
`ReplayBuffer.insert` and `ReplayBuffer.sample` (K4)."""

SPAN = "bench.replay"


def read(run):
    if not run.ops:  # no device trace
        return None
    if not run.span_count(SPAN) or run.iterations <= 0:
        return None
    return run.device_s(SPAN) / run.iterations * 1e3
