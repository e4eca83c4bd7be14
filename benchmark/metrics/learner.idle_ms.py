"""Learner: device idle ms per `update_high_utd` call put down to the
learner's host dispatch: the gaps in the union of the window's device
operations that began while the host's innermost program span was
`learner.update` or one nested in it, over the `learner.update` spans."""

from benchmark import program_spans
from benchmark.trace import merged

SPAN = "learner.update"


def read(run):
    if not run.ops:  # no device trace
        return None
    program = program_spans.load(run)
    calls = program.count(SPAN) if program is not None else 0
    if not calls:
        return None
    idle, t = 0, run.window_ns[0]
    for s, e in merged(run.ops, run.window_ns) + [(run.window_ns[1], run.window_ns[1])]:
        if s > t and program.within(program.open_at(t), SPAN):
            idle += s - t
        t = max(t, e)
    return idle / calls * 1e-6
