"""Phase timer: the port's own copy of `serl_tpu/utils/timer.py`'s `Timer`,
and `torch_profile`, the counterpart of its `jax_profile`.

tick/tock and a context manager; `get_average_times(reset=True)` returns the
mean wall time per phase since the last reset. The host clock only: a phase
that ends in asynchronous CUDA work is timed to its enqueue unless it
synchronizes.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.counts = defaultdict(int)
        self.times = defaultdict(float)
        self.start_times = {}

    def tick(self, key: str):
        if key in self.start_times:
            raise ValueError(f"Timer is already ticking for key: {key}")
        self.start_times[key] = time.perf_counter()

    def tock(self, key: str):
        if key not in self.start_times:
            raise ValueError(f"Timer is not ticking for key: {key}")
        self.counts[key] += 1
        self.times[key] += time.perf_counter() - self.start_times[key]
        del self.start_times[key]

    @contextlib.contextmanager
    def context(self, key: str):
        self.tick(key)
        try:
            yield
        finally:
            self.tock(key)

    def get_average_times(self, reset: bool = True):
        ret = {k: self.times[k] / self.counts[k] for k in self.counts}
        if reset:
            self.reset()
        return {k: round(v, 6) for k, v in ret.items()}


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a torch.profiler trace of a code block into
    `logdir/trace.json` (chrome://tracing, Perfetto): the counterpart of the
    JAX package's `jax_profile`. CPU activity always, CUDA activity where the
    process has a card. Yields the profiler, whose `key_averages()` the
    caller may read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
