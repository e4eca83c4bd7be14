"""Env: host ms per loop iteration in `PandaPickCubeEnv.step_auto_reset`,
the program's `env.step` spans over its `loop.iteration` spans."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "env.step", "loop.iteration")
