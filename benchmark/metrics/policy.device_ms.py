"""Policy: device ms per loop iteration of the operations launched in
`SACAgent.sample_actions` (the encoders' forward over every env's frames,
the actor's MLP through K5, the sample)."""

SPAN = "bench.policy"


def read(run):
    if not run.ops:  # no device trace
        return None
    if not run.span_count(SPAN) or run.iterations <= 0:
        return None
    return run.device_s(SPAN) / run.iterations * 1e3
