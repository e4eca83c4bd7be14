"""Learner: the share of the window's `SACAgent.update` steps that were a
CUDA graph's replay, the program's `learner.replay` spans over its
`learner.critic` and `learner.actor` spans (one of each an update of
`update_high_utd`). 0 where the program captures graphs (a `learner.capture`
or `learner.replay` span anywhere in the run) and replays none in the
window; None where the window holds no learner step, or the program never
captured or replayed a graph (a program without CUDA graphs)."""

from benchmark import program_spans


def read(run):
    program = program_spans.load(run)
    if program is None:
        return None
    updates = program.count("learner.critic") + program.count("learner.actor")
    graphs = any(r.name in ("learner.capture", "learner.replay") for r in program.records)
    if not updates or not graphs:
        return None
    return program.count("learner.replay") / updates
