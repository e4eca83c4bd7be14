"""Learner (optimizer): host ms per `update_high_utd` call in the optimizer
steps of every group (zero-gradient steps too) and the target update, the
program's `learner.optimizer` spans over its `learner.update` spans."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "learner.optimizer", "learner.update")
