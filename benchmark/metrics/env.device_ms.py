"""Env: device ms per loop iteration of the operations launched in
`PandaPickCubeEnv.step_auto_reset` (K1, K2, the plain obs, reward and reset)."""

SPAN = "bench.env"


def read(run):
    if not run.ops:  # no device trace
        return None
    if not run.span_count(SPAN) or run.iterations <= 0:
        return None
    return run.device_s(SPAN) / run.iterations * 1e3
