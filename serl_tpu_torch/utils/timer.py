"""Phase timer: the port's own copy of `serl_tpu/utils/timer.py`'s `Timer`,
`torch_profile`, the counterpart of its `jax_profile`, and the program's
spans.

tick/tock and a context manager; `get_average_times(reset=True)` returns the
mean wall time per phase since the last reset. The host clock only: a phase
that ends in asynchronous CUDA work is timed to its enqueue unless it
synchronizes.

Spans: `with span("learner.update"):` records the block's name, its start
and end on `time.time_ns()` (the clock of the CPU events of torch.profiler's
kineto trace, so a span lies on the device trace's timeline), the index of
its parent span, its thread and the iteration id of the `loop.iteration`
span it belongs to. Spans record only while a torch profiler is recording,
or between `enable()` and `disable()`; otherwise `span` returns one shared
no-op context. Each thread keeps its own stack of open spans; a span whose
innermost open span on its thread has the same name records nothing (a
subclass's method that calls its base's opens one span). Records stay in a
bounded buffer (`CAPACITY`; the spans that find it full are counted in
`dropped()`), read by `records()` and emptied by `clear()`. While spans
record, each garbage collection is a `host.gc` span under the span open on
its thread.
"""

import contextlib
import gc
import json
import os
import threading
import time
from array import array
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile

CAPACITY = 1 << 18  # records; ~70 an iteration of the fused DrQ loop
GC_SPAN = "host.gc"

_profiling = torch._C._autograd._profiler_enabled
_enabled = False
# A record is a tuple (name, start_ns, parent, thread, iteration) in `_buffer` and its end in
# `_ends` (0 while open): tuples of atoms and an array, which the garbage collector does not
# traverse. A thread's stack holds (index, name, iteration, the `_ends` it is in) of its
# open spans: a span open across a `clear()` ends in the array that went with it.
_buffer: list = []
_ends = array("q")
_dropped = 0
_gc_hooked = False
# the buffer, the drop count and the hook, across threads; reentrant, as a collection may
# start on the thread that holds it
_lock = threading.RLock()
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]  # None while the span is open
    parent: int  # index of the parent in `records()`; -1 for a root
    thread: int  # the OS thread id, as kineto's CPU events carry it
    iteration: Optional[int]  # the id of the enclosing `loop.iteration` span


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    """This thread's open spans; the thread's id is kept beside them."""
    try:
        return _local.stack
    except AttributeError:
        _local.thread = threading.get_native_id()  # a system call: once a thread
        _local.stack = []
        return _local.stack


def _open(name: str, stack: list, iteration: Optional[int]):
    """Record an open span under the innermost one of `stack` and push it;
    None (counted as dropped) when the buffer is full."""
    global _dropped, _gc_hooked
    top = stack[-1] if stack else None
    if iteration is None and top is not None:
        iteration = top[2]
    start = time.time_ns()
    _lock.acquire()
    try:
        if not _gc_hooked:
            gc.callbacks.append(_gc_hook)
            _gc_hooked = True
        if len(_buffer) >= CAPACITY:
            _dropped += 1
            return None
        # a parent that went with a clear() is none
        parent = top[0] if top is not None and top[3] is _ends else -1
        # a collection can start as the tuple is made, and record its span first
        _buffer.append((name, start, parent, _local.thread, iteration))
        index = len(_buffer) - 1
        _ends.append(0)
        entry = (index, name, iteration, _ends)
    finally:
        _lock.release()
    stack.append(entry)
    return entry


def _close(entry, stack: list) -> None:
    entry[3][entry[0]] = time.time_ns()
    if stack and stack[-1] is entry:
        stack.pop()


class _Span:
    __slots__ = ("name", "iteration", "entry")

    def __init__(self, name: str, iteration: Optional[int]):
        self.name = name
        self.iteration = iteration
        self.entry = None

    def __enter__(self):
        stack = _stack()
        if not stack or stack[-1][1] != self.name:
            self.entry = _open(self.name, stack, self.iteration)
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            _close(self.entry, _stack())
        return False


def span(name: str, iteration: Optional[int] = None):
    """A context manager that records the block as span `name` while spans
    record (see the module's docstring); `iteration` sets the id that the
    span and the spans inside it carry (the loop's iteration count)."""
    if not (_enabled or _profiling()):
        return _NO_SPAN
    return _Span(name, iteration)


def _gc_hook(phase: str, info) -> None:
    if not (_enabled or _profiling()):
        return
    stack = _stack()
    if phase == "start":
        _open(GC_SPAN, stack, None)
    elif stack and stack[-1][1] == GC_SPAN:
        _close(stack[-1], stack)


def enable() -> None:
    """Record spans without a profiler, until `disable()`."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def records() -> List[SpanRecord]:
    """The recorded spans in the order they opened."""
    _lock.acquire()
    try:
        return [SpanRecord(name, start, end or None, parent, thread, iteration)
                for (name, start, parent, thread, iteration), end in zip(_buffer, _ends)]
    finally:
        _lock.release()


def dropped() -> int:
    """Spans not recorded because the buffer was full, since the last clear()."""
    return _dropped


def clear() -> None:
    global _buffer, _ends, _dropped
    _lock.acquire()
    try:
        _buffer, _ends = [], array("q")
        _dropped = 0
    finally:
        _lock.release()


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
        """Time the block as phase `key`, and record it as span `key`."""
        self.tick(key)
        try:
            with span(key):
                yield
        finally:
            self.tock(key)

    def get_average_times(self, reset: bool = True):
        ret = {k: self.times[k] / self.counts[k] for k in self.counts}
        if reset:
            self.reset()
        return {k: round(v, 6) for k, v in ret.items()}


def _add_spans(path: str, spans: List[SpanRecord]) -> None:
    """Append `spans` to the chrome trace at `path` as complete events on the
    timeline of its CPU and device events (microseconds past the trace's
    `baseTimeNanoseconds`)."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"iteration": s.iteration}}
        for s in spans if s.end_ns is not None)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a torch.profiler trace of a code block into
    `logdir/trace.json` (chrome://tracing, Perfetto): the counterpart of the
    JAX package's `jax_profile`. CPU activity always, CUDA activity where the
    process has a card, and the program's spans recorded in the block, on
    the same timeline. Yields the profiler, whose `key_averages()` the
    caller may read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        start = time.time_ns()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in records() if s.start_ns >= start])
