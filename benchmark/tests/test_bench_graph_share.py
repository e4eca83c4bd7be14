"""`metrics/learner.graph_share.py` on made-up program spans: the share of
the window's `SACAgent.update` steps that were a CUDA graph's replay."""

import pytest

from benchmark import manifest, trace
from serl_tpu_torch.utils import timer
from serl_tpu_torch.utils.timer import SpanRecord

MS = 1_000_000


def _run(monkeypatch, records, window_ms=(0, 1000)):
    monkeypatch.setattr(timer, "records", lambda: records)
    return trace.Run(config=manifest.config("drq_small"), traffic=manifest.traffic("learn"),
                     calls={"iteration": []}, iterations=1,
                     window_ns=(window_ms[0] * MS, window_ms[1] * MS))


def _calls(n_calls, replayed, utd=4, start_ms=0):
    """`n_calls` `learner.update` spans of `utd` critic steps and an actor
    step each, the steps numbered in `replayed` holding a `learner.replay`."""
    records, t, step = [], start_ms, 0
    for _ in range(n_calls):
        update = len(records)
        records.append(SpanRecord("learner.update", t * MS, (t + 50) * MS, -1, 1, 0))
        for i in range(utd + 1):
            records.append(SpanRecord("learner.critic" if i < utd else "learner.actor",
                                      (t + 1 + 9 * i) * MS, (t + 9 + 9 * i) * MS, update, 1, 0))
            if step in replayed:
                records.append(SpanRecord("learner.replay", (t + 2 + 9 * i) * MS,
                                          (t + 8 + 9 * i) * MS, len(records) - 1, 1, 0))
            step += 1
        t += 60
    return records


def test_graph_share_counts_replays_over_the_window_steps(monkeypatch):
    reader = manifest.metric("learner.graph_share")
    # the check's first three calls: each key's first step eager, 13 of 15 replayed
    records = _calls(3, replayed=set(range(15)) - {0, 4})
    assert reader.read(_run(monkeypatch, records)) == pytest.approx(13 / 15, rel=1e-12)
    # every step of the window replayed; a call past the window is left out
    records = _calls(4, replayed=set(range(15))) + _calls(1, set(), start_ms=2000)
    assert reader.read(_run(monkeypatch, records, (0, 180))) == 1.0


def test_graph_share_is_none_without_replays_or_spans(monkeypatch):
    reader = manifest.metric("learner.graph_share")
    # a program that records the learner's steps and never captures (the parent's)
    assert reader.read(_run(monkeypatch, _calls(2, replayed=set()))) is None
    assert reader.read(_run(monkeypatch, [])) is None
    # a window without learner steps
    records = _calls(1, replayed={0}, start_ms=2000)
    assert reader.read(_run(monkeypatch, records, (0, 1000))) is None


def test_graph_share_is_zero_where_every_step_fell_back_to_eager(monkeypatch):
    """Captures were tried at set-up (their spans lie before the window) and
    each key runs eager since: the share reads 0, not nothing."""
    reader = manifest.metric("learner.graph_share")
    capture = [SpanRecord("learner.capture", 0, 5 * MS, -1, 1, 0)]
    records = capture + _calls(3, replayed=set(), start_ms=100)
    assert reader.read(_run(monkeypatch, records, (90, 1000))) == 0.0
