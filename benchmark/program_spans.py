"""The program's own spans, read after a traced window.

`serl_tpu_torch/utils/timer.py` records a span around each layer's call
(`loop.iteration`, `env.step`, `learner.update` and the learner's parts,
`host.gc`, ...) on `time.time_ns()`, the clock of the trace, while a torch
profiler records; the window's profiler is one. `load(run)` reads them,
keeps those that overlap `run.window_ns`, clipped to it, and answers which
program span was innermost on the host at a time. A program without the
recorder, or a run without spans, gives None, and so do the readers.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional


def _recorded() -> List:
    try:
        from serl_tpu_torch.utils import timer
    except ImportError:
        return []
    records = getattr(timer, "records", None)
    return records() if records is not None else []


class Program:
    """The closed spans of one window: names, clipped intervals, parents."""

    def __init__(self, records: List, window):
        w0, w1 = window
        self.records = records
        self.inside = [i for i, r in enumerate(records)
                       if r.end_ns is not None and r.end_ns > w0 and r.start_ns < w1]
        self.clipped = {i: (max(records[i].start_ns, w0), min(records[i].end_ns, w1))
                        for i in self.inside}
        by_thread: Dict[int, List[int]] = defaultdict(list)
        for i in self.inside:  # records are in the order they opened
            by_thread[records[i].thread].append(i)
        self.by_thread = {t: (ids, [records[i].start_ns for i in ids])
                          for t, ids in by_thread.items()}

    def count(self, name: str) -> int:
        return sum(1 for i in self.inside if self.records[i].name == name)

    def total_ms(self, name: str, under: Optional[str] = None) -> float:
        return sum(e - s for i, (s, e) in self.clipped.items() if self.records[i].name == name
                   and (under is None or self.within(self.records[i].parent, under))) * 1e-6

    def within(self, i: int, name: str) -> bool:
        """Whether span `i` is span `name` or nested in one."""
        while i >= 0:
            if self.records[i].name == name:
                return True
            i = self.records[i].parent
        return False

    def open_at(self, t: int) -> int:
        """The innermost program span open at `t` (the latest to start, of
        every thread's innermost), or -1."""
        best = -1
        for ids, starts in self.by_thread.values():
            k = bisect.bisect_right(starts, t) - 1
            if k < 0:
                continue
            i = ids[k]  # spans of one thread nest: the innermost holding t is i or its ancestor
            while i >= 0 and (self.records[i].end_ns or t) < t:
                i = self.records[i].parent
            if i >= 0 and (best < 0 or self.records[i].start_ns > self.records[best].start_ns):
                best = i
        return best


def load(run) -> Optional[Program]:
    """The program's spans in `run`'s window, or None where there are none."""
    records = _recorded()
    if not records or run.window_ns[1] <= run.window_ns[0]:
        return None
    program = Program(records, run.window_ns)
    return program if program.inside else None


def per(run, name: str, base: str, under: Optional[str] = None) -> Optional[float]:
    """Summed ms of span `name` (nested in `under` if given) per span `base`."""
    program = load(run)
    if program is None:
        return None
    n = program.count(base)
    return program.total_ms(name, under) / n if n else None
