"""Learner: host ms per `update_high_utd` call in the gradients' dispatch,
the program's `learner.backward` spans (`TrainState.apply_loss_fns`, around
each trained group's `torch.autograd.grad`) over its `learner.update` spans."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "learner.backward", "learner.update")
