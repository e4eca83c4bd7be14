"""The port's span recorder (`serl_tpu_torch/utils/timer.py`), the spans at
its layer boundaries, and the benchmark's readers of them, on the CPU.

  * While off, `span` is one shared no-op context and records and allocates
    nothing; a collection then records nothing either.
  * While `enable()`d or while a torch profiler records: spans nest with
    their parents and iteration ids per thread, the bounded buffer counts
    its drops, a same-name span inside another records once, a collection
    is a `host.gc` child of the open span, and a span brackets kineto's
    CPU events of its block (the same clock).
  * `Timer.context` averages as before and records its phase as a span.
  * The fused DrQ loop, one iteration past its learning threshold under a
    CPU profiler, records the exact tree of spans the metrics read.
  * The benchmark's readers of the program's spans
    (`benchmark/metrics/{learner.*,env.host_ms,loop.gc_ms}.py`) on a made-up
    window with known answers.
"""

import gc
import sys
import threading
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import manifest, trace
from serl_tpu_torch.utils import timer
from serl_tpu_torch.utils.timer import SpanRecord, Timer, span


@pytest.fixture(autouse=True)
def fresh_recorder():
    """An empty recorder, and no automatic collection (its host.gc spans would
    land anywhere in a test's tree; `gc.collect()` still runs the hooks)."""
    timer.disable()
    timer.clear()
    gc.disable()
    yield
    gc.enable()
    timer.disable()
    timer.clear()


def _names(records):
    return [r.name for r in records]


def test_span_off_is_one_shared_no_op_that_records_and_allocates_nothing():
    assert not torch._C._autograd._profiler_enabled()
    first = span("a")
    assert span("b", iteration=3) is first
    with span("a"):
        with span("b"):
            pass
    blocks = sys.getallocatedblocks()
    for _ in range(10_000):
        with span("learner.update"):
            pass
    assert sys.getallocatedblocks() - blocks < 100  # none a call
    assert timer.records() == [] and timer.dropped() == 0


def test_enabled_spans_nest_with_parents_and_iterations_per_thread():
    timer.enable()
    both = threading.Barrier(2)  # both alive at once: two thread ids

    def work(it):
        both.wait()
        with span("loop.iteration", iteration=it):
            with span("learner.update"):
                with span("learner.forward"):
                    pass
            with span("env.step"):
                pass

    threads = [threading.Thread(target=work, args=(it,)) for it in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with span("outside"):
        pass
    records = timer.records()
    assert len(records) == 9 and all(r.end_ns >= r.start_ns for r in records)
    by_thread = {}
    for i, r in enumerate(records):
        by_thread.setdefault(r.thread, []).append(i)
    assert len(by_thread) == 3
    for ids in by_thread.values():
        rs = [records[i] for i in ids]
        if rs[0].name == "outside":
            assert rs[0].parent == -1 and rs[0].iteration is None
            continue
        root, update, forward, env = ids
        assert _names(rs) == ["loop.iteration", "learner.update", "learner.forward", "env.step"]
        assert records[root].parent == -1
        assert records[update].parent == root and records[env].parent == root
        assert records[forward].parent == update
        assert len({r.iteration for r in rs}) == 1 and rs[0].iteration in (7, 8)
        assert records[root].start_ns <= records[forward].start_ns <= records[forward].end_ns \
            <= records[root].end_ns
    assert {records[ids[0]].iteration for ids in by_thread.values()} == {7, 8, None}


def test_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(timer, "CAPACITY", 3)
    timer.enable()
    with span("loop.iteration", iteration=0):
        for _ in range(4):
            with span("env.step"):
                pass
    assert _names(timer.records()) == ["loop.iteration", "env.step", "env.step"]
    assert timer.dropped() == 2
    timer.clear()
    assert timer.records() == [] and timer.dropped() == 0
    with span("env.step"):
        pass
    assert _names(timer.records()) == ["env.step"]


def test_threads_lose_no_record_or_drop_at_the_bound(monkeypatch):
    monkeypatch.setattr(timer, "CAPACITY", 5_000)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timer.enable()

    def work(it):
        for _ in range(100):
            with span("loop.iteration", iteration=it):
                with span("env.step"):
                    pass

    threads = [threading.Thread(target=work, args=(it,)) for it in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    records = timer.records()
    assert len(records) == 5_000 and len(records) + timer.dropped() == 32 * 100 * 2
    for r in records:
        if r.name == "env.step" and r.parent >= 0:
            parent = records[r.parent]
            assert (parent.name, parent.thread, parent.iteration) == \
                ("loop.iteration", r.thread, r.iteration)


def test_same_name_inside_records_once_and_clear_drops_stale_parents():
    timer.enable()
    with span("learner.update"):
        with span("learner.update"):  # a subclass's method calling its base's
            with span("learner.critic"):
                pass
        timer.clear()
        with span("learner.actor"):  # its parent went with the clear
            pass
    records = timer.records()
    assert _names(records) == ["learner.actor"] and records[0].parent == -1
    timer.clear()
    with span("learner.update"):
        with span("learner.update"):
            with span("learner.critic"):
                pass
    records = timer.records()
    assert _names(records) == ["learner.update", "learner.critic"]
    assert records[1].parent == 0


def test_spans_record_while_a_profiler_records_on_its_clock():
    x = torch.randn(64, 64)
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("program.mm"):
            x @ x
    with span("after"):
        pass
    records = timer.records()
    assert _names(records) == ["program.mm"]
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    s = records[0]
    assert s.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= s.end_ns


def test_gc_is_a_span_under_the_open_one_and_silent_while_off(monkeypatch):
    opened = []
    real_open = timer._open
    monkeypatch.setattr(timer, "_open", lambda *a: opened.append(a[0]) or real_open(*a))
    gc.collect()
    assert timer.records() == [] and opened == []
    timer.enable()
    with span("loop.iteration", iteration=5):
        gc.collect()
    timer.disable()
    gc.collect()
    records = timer.records()
    assert _names(records) == ["loop.iteration", timer.GC_SPAN]
    assert records[1].parent == 0 and records[1].iteration == 5
    assert records[0].start_ns <= records[1].start_ns <= records[1].end_ns <= records[0].end_ns
    assert opened == ["loop.iteration", timer.GC_SPAN]


def test_timer_context_averages_and_records_its_span(monkeypatch):
    clock = [0.0, 2.0, 10.0, 11.0, 12.0, 14.0]  # train 2 s, then 4 s around 1 s of sampling
    t = Timer()
    monkeypatch.setattr(timer.time, "perf_counter", lambda: clock.pop(0))
    with t.context("train"):
        pass
    timer.enable()
    with t.context("train"):
        with t.context("sample_replay_buffer"):
            pass
    monkeypatch.undo()
    assert clock == []
    assert t.get_average_times() == {"train": 3.0, "sample_replay_buffer": 1.0}
    assert t.get_average_times() == {}
    records = timer.records()
    assert _names(records) == ["train", "sample_replay_buffer"] and records[1].parent == 0
    with pytest.raises(ValueError):
        t.tock("train")


def _tree(records, i):
    return [(records[j].name, _tree(records, j)) for j in range(len(records))
            if records[j].parent == i]


def test_fused_drq_loop_records_the_span_tree_the_metrics_read():
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment

    torch.manual_seed(0)
    env, agent, rb, _, init_fn, run_chunk = make_drq_sim_experiment(
        device="cpu", num_envs=4, image_size=32, batch_size=8, utd_ratio=2, updates_per_iter=2,
        training_starts=0, random_steps=8, buffer_capacity=400)
    carry = init_fn(agent, 0)
    carry, metrics = run_chunk(carry, 3)  # 12 rows: under batch x UTD = 16
    assert float(metrics["critic_loss"].abs().sum()) == 0.0 and timer.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        carry, metrics = run_chunk(carry, 1)
    assert float(metrics["critic_loss"].abs().sum()) > 0.0
    records = timer.records()
    assert {r.iteration for r in records} == {3}
    counts = Counter(_names(records))
    assert counts == {"loop.iteration": 1, "policy.sample": 1, "env.step": 1, "replay.insert": 1,
                      "replay.sample": 2, "learner.update": 2, "learner.draws": 2,
                      "learner.augment": 2, "learner.critic": 4, "learner.actor": 2,
                      "learner.forward": 8, "learner.backward": 8, "learner.optimizer": 10}
    critic = ("learner.critic", [("learner.forward", []), ("learner.backward", []),
                                 ("learner.optimizer", []), ("learner.optimizer", [])])
    # the groups in sorted order: actor, critic (no loss: no spans), temperature
    actor = ("learner.actor", [("learner.forward", []), ("learner.backward", []),
                               ("learner.forward", []), ("learner.backward", []),
                               ("learner.optimizer", [])])
    update = ("learner.update", [("learner.draws", []), ("learner.augment", []), critic, critic,
                                 actor])
    assert _tree(records, -1) == [("loop.iteration", [
        ("policy.sample", []), ("env.step", []), ("replay.insert", []),
        ("replay.sample", []), update, ("replay.sample", []), update])]


# -- the benchmark's readers of the program's spans, on a made-up window

MS = 1_000_000


def _record(name, start_ms, end_ms, parent, iteration):
    return SpanRecord(name, int(start_ms * MS), int(end_ms * MS), parent, 1, iteration)


def _made_up_run(monkeypatch, with_spans=True, with_ops=True):
    records = [
        _record("host.gc", 0, 1, -1, None),  # the benchmark's own collection: not the loop's
        _record("loop.iteration", 2, 50, -1, 0),  # 1
        _record("env.step", 3, 8, 1, 0),
        _record("learner.update", 10, 40, 1, 0),  # 3
        _record("learner.critic", 11, 30, 3, 0),  # 4: an eager step
        _record("learner.forward", 12, 17, 4, 0),
        _record("learner.backward", 18, 20, 4, 0),
        _record("learner.optimizer", 21, 24, 4, 0),
        _record("host.gc", 25, 26, 4, 0),
        _record("learner.actor", 31, 39, 3, 0),  # 9: a replayed step
        _record("learner.replay", 32, 38, 9, 0),
        _record("loop.iteration", 50, 98, -1, 1),  # 11
        _record("env.step", 51, 54, 11, 1),
        _record("learner.update", 60, 90, 11, 1),  # 13
        _record("learner.critic", 60.5, 80, 13, 1),  # 14: a step captured, then replayed
        _record("learner.forward", 61, 71, 14, 1),
        _record("learner.backward", 72, 74, 14, 1),
        _record("learner.optimizer", 75, 79, 14, 1),
        _record("learner.replay", 79.5, 80, 14, 1),
        _record("learner.actor", 81, 89, 13, 1),  # 19: an eager step
        _record("learner.optimizer", 82, 83, 19, 1),
        _record("learner.update", 120, 130, -1, None),  # past the window
    ]
    monkeypatch.setattr(timer, "records", lambda: records if with_spans else [])
    config, traffic = manifest.config("drq_small"), manifest.traffic("learn")
    run = trace.Run(config=config, traffic=traffic, calls={"iteration": []}, iterations=2,
                    window_ns=(0, 100 * MS))
    if with_ops:
        # busy 0-12, 15-45, 55-85 ms: idle 12-15 (in a learner.forward), 45-55 (in the
        # loop, no learner span), 85-100 (in the second learner.update)
        run.ops = [trace.DeviceOp("a", 0, 12 * MS, "bench.learner"),
                   trace.DeviceOp("b", 15 * MS, 45 * MS, "bench.learner"),
                   trace.DeviceOp("c", 55 * MS, 70 * MS, "bench.env"),
                   trace.DeviceOp("d", 60 * MS, 85 * MS, "bench.learner")]
    return run


@pytest.mark.parametrize("name, want", [
    ("learner.forward.host_ms", (5 + 10) / 2),
    ("learner.backward.host_ms", (2 + 2) / 2),
    ("learner.optimizer.host_ms", (3 + 5) / 2),
    ("learner.idle_ms", (3 + 15) / 2),
    ("learner.launches", 3 / 2),
    ("env.host_ms", (5 + 3) / 2),
    ("loop.gc_ms", 1 / 2),
    ("learner.graph_share", 2 / 4),
])
def test_program_span_readers_on_a_made_up_window(monkeypatch, name, want):
    reader = manifest.metric(name)
    assert reader.read(_made_up_run(monkeypatch)) == pytest.approx(want, rel=1e-12)
    assert reader.read(_made_up_run(monkeypatch, with_spans=False)) is None
    device = name in ("learner.idle_ms", "learner.launches")
    no_ops = reader.read(_made_up_run(monkeypatch, with_ops=False))
    assert no_ops is None if device else no_ops == pytest.approx(want, rel=1e-12)
