"""One traced window: the device's trace reduced to what the metric readers read.

torch.profiler traces the card only (CUPTI: kernels, copies, fills and the
CUDA runtime calls that launched them); it records no CPU op, which would
slow the host's dispatch and move the very idle time it measures. The
benchmark keeps its own spans ("bench.<layer>") on the host's clock, the one
the trace's timestamps are on, around the calls into each layer, by wrapping
the bound methods of the instances it built; the program is not edited. A
device operation belongs to the span that was open on the host when the
runtime call with its correlation id launched it, on any host thread
(autograd's backward too). The device's busy time is the union of its
operations' intervals inside the window, itself a span ("bench.window")
that ends on a device-to-host read.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 100


@dataclass
class DeviceOp:
    name: str
    start: int  # ns
    end: int
    span: Optional[str]  # the bench span open at its launch


@dataclass
class Run:
    """What a traced run hands the metric readers."""

    config: Dict
    traffic: Dict
    calls: Dict  # the flops module's {"policy", "update", "iteration"} Call lists
    iterations: int  # loop iterations completed in the window
    window_ns: Tuple[int, int]
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    ops: List[DeviceOp] = field(default_factory=list)
    unlinked: int = 0  # device operations whose launch the trace does not show
    open_at: Callable[[int], Optional[str]] = lambda t: None

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.ops, self.window_ns)) * 1e-9

    def device_s(self, span: Optional[str] = None, match=None) -> float:
        """Summed device time of the operations launched in `span` (any
        span if None) whose name `match` accepts (all if None)."""
        return sum(o.end - o.start for o in self.ops
                   if (span is None or o.span == span) and (match is None or match(o.name))
                   ) * 1e-9

    def span_count(self, span: str) -> int:
        return len(self.spans.get(span, ()))


def merged(ops: List[DeviceOp], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The union of the operations' intervals, clipped to the window."""
    ivs = sorted((max(o.start, window[0]), min(o.end, window[1])) for o in ops
                 if o.end > window[0] and o.start < window[1])
    out: List[List[int]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Spans:
    """The benchmark's spans, {name: [(start, end)]} in ns on the host's clock."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans[name].append((start, time.time_ns()))


def profiler():
    """The card's activity only; a run on the CPU (the tests) traces the CPU."""
    activity = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[activity.CUDA if torch.cuda.is_available() else activity.CPU])


def _kind(e) -> str:
    """kineto's activity type; from the device and the name where this
    torch's events do not carry it (spans are "bench.*", launches the CUDA
    runtime's and driver's calls)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    cpu = e.device_type() == torch.autograd.DeviceType.CPU
    if e.name().startswith("bench."):
        return "user_annotation" if cpu else "gpu_user_annotation"
    if cpu:
        return "cuda_runtime" if re.match(r"(cuda|cu)[A-Z]", e.name()) else "cpu_op"
    return "kernel"


def _raw_events(prof):
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("torch.profiler kept no kineto results: no device trace")
    return results.events()


def reduce(prof, run: Run, recorded: Dict[str, List[Tuple[int, int]]]) -> Run:
    """Fill `run.spans`, `run.ops` and `run.window_ns` from a stopped
    profiler and the spans recorded beside it."""
    spans = {k: list(v) for k, v in recorded.items()}
    launches: Dict[int, int] = {}
    cpu_ops: Dict[int, int] = {}
    device = []
    for e in _raw_events(prof):
        kind = _kind(e)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if kind in RUNTIME_KINDS:
                launches[e.correlation_id()] = e.start_ns()
            elif kind != "user_annotation":
                cpu_ops[e.correlation_id()] = e.start_ns()
        elif kind in DEVICE_KINDS:
            device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.correlation_id(), e.linked_correlation_id()))
    if len(spans.get(WINDOW, ())) != 1:
        raise RuntimeError(f"{len(spans.get(WINDOW, ()))} window spans were recorded, not 1")
    run.window_ns = spans.pop(WINDOW)[0]
    inner = sorted((s, e, name) for name, ivs in spans.items() for s, e in ivs)
    starts = [s for s, _, _ in inner]

    def open_at(t: int) -> Optional[str]:
        # the layer spans do not nest: only the last one to start can hold t
        i = bisect.bisect_right(starts, t) - 1
        return inner[i][2] if i >= 0 and t <= inner[i][1] else None

    unlinked = 0
    for name, s, e, corr, linked in device:
        t = launches.get(corr, cpu_ops.get(linked))
        if t is None:
            unlinked += 1
        run.ops.append(DeviceOp(name, s, e, None if t is None else open_at(t)))
    run.spans = dict(spans)
    run.unlinked = unlinked
    run.open_at = open_at
    return run


def breakdown(run: Run, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the idle gaps
    of the window summed by the bench span open on the host as each began."""
    by_name: Dict[str, int] = defaultdict(int)
    for o in run.ops:
        if o.end > run.window_ns[0] and o.start < run.window_ns[1]:
            by_name[o.name[:NAME_CHARS]] += o.end - o.start
    gaps: Dict[str, int] = defaultdict(int)
    t = run.window_ns[0]
    for s, e in merged(run.ops, run.window_ns) + [(run.window_ns[1], run.window_ns[1])]:
        if s > t:
            gaps[run.open_at(t) or "loop (no bench span)"] += s - t
        t = max(t, e)
    def ranked(d):
        return [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}
