"""Learner: host ms per `update_high_utd` call in the loss forwards, the
program's `learner.forward` spans (`TrainState.apply_loss_fns`, around each
trained group's loss) over its `learner.update` spans."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "learner.forward", "learner.update")
