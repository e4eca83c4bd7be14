"""Learner: host ms per `update_high_utd` call, the span the benchmark opens around it."""

SPAN = "bench.learner"


def read(run):
    spans = run.spans.get(SPAN, ())
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e-6
