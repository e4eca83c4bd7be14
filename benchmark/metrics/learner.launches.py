"""Learner: device operations launched per `update_high_utd` call. The
trace keeps no launch times, so an operation is the learner's when the
benchmark's `bench.learner` span, directly around the program's
`learner.update`, was open at its launch; the count is over the program's
`learner.update` spans."""

from benchmark import program_spans

SPAN = "bench.learner"


def read(run):
    if not run.ops:  # no device trace
        return None
    program = program_spans.load(run)
    calls = program.count("learner.update") if program is not None else 0
    if not calls:
        return None
    return sum(1 for o in run.ops if o.span == SPAN) / calls
