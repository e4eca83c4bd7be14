"""Whole step: host ms per loop iteration in garbage collections, the
program's `host.gc` spans inside its `loop.iteration` spans over their count
(the collection the benchmark itself makes as the window opens is left out)."""

from benchmark import program_spans


def read(run):
    return program_spans.per(run, "host.gc", "loop.iteration", under="loop.iteration")
