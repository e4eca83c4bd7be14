"""Data-parallel dry run of the fused programs over N torch.distributed ranks.

Counterpart of the JAX package's `__graft_entry__.py::dryrun_multichip(n)`:
the state, pixel and chained fwbw programs, each laid out by
`distributed/sharding.py` (envs and ring streams split over the ranks,
params replicated, gradients averaged), run for a few iterations with the
layout checked after them:

  * every env leaf holds N / n rows on each rank, every ring N / n streams,
    the routed rings' cursors and sizes the rank's streams;
  * a digest of the params, optimizer states and generator, equal on every
    rank (one all_gather of the digests);
  * env_steps == iters x N, and the routed rows summed over the ranks ==
    iters x N (each transition routed once);
  * every learner stepped.

    python -m serl_tpu_torch.examples.dryrun_multichip --nproc 2 --device cpu
    python -m serl_tpu_torch.examples.dryrun_multichip --nproc 2 --backend gloo \\
        --full_width                         # two ranks sharing one card
    python -m serl_tpu_torch.examples.dryrun_multichip --nproc 4   # NCCL, a card a rank

One process a rank (`torch.multiprocessing`, spawn), rank r on cuda:r under
NCCL (the default on the card), or ranks sharing cards under gloo; `--device
cpu` takes gloo. NCCL with more ranks than cards raises: pass `--backend
gloo`. By default each program runs at the JAX dry run's sizes (state: 2n
envs, batch 2n x UTD 2, 128 iterations; pixels: n envs at 32 px, 8
iterations; fwbw: 2n chained envs, 16 iterations); `--full_width` runs
bench_state's configuration (128 envs, batch 256 x UTD 8, ring 100,000),
bench_pixels' (16 envs, two 128 px cameras, batch 256 x UTD 4, 2 updates
an iteration) and the fwbw example's recipe (32 chained envs, batch 256 x
UTD 4 a learner, demos cut to 100 steps a stream), each past its learner
gate. The parent joins every rank and raises if one fails; a rank that
dies or a collective that fails ends the run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import math
import os
import socket
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch

PROGRAMS = ("state", "pixels", "fwbw")
JAX_ITERS = {"state": 128, "pixels": 8, "fwbw": 16}  # __graft_entry__.py's
# full width: iterations past the learner gate (the gate first, then these)
FULL_WIDTH_ITERS = {"state": 20, "pixels": 6, "fwbw": 10}
# the fwbw example's docstring recipe, its demos cut to 100 steps a stream
FWBW_RECIPE = ["--bc_weight", "0.3", "--discount", "0.98", "--intervention_mode", "rescue",
               "--intervention_prob", "0.02", "--intervention_decay_steps", "1500000",
               "--intervention_min_prob", "0.008", "--fresh_reset_prob", "0.1",
               "--demo_steps", "100"]
COLLECTIVE_TIMEOUT_S = 600
MAX_GATE_ITERS = 400  # the fwbw recipe's gates open after ~150 iterations


# ---------------------------------------------------------------- the programs


def state_config(world: int, full_width: bool) -> dict:
    """make_state_sim_experiment's overrides: bench_state's configuration, or
    the JAX dry run's at `world` ranks."""
    if full_width:
        return dict(num_envs=128, batch_size=256, utd_ratio=8, updates_per_iter=1,
                    training_starts=1000, random_steps=1000, buffer_capacity=100_000)
    n = 2 * world
    return dict(num_envs=n, batch_size=n, utd_ratio=2, updates_per_iter=1, training_starts=0,
                random_steps=0, buffer_capacity=n * 64)


def pixel_config(world: int, full_width: bool) -> dict:
    """make_drq_sim_experiment's arguments: bench_pixels' configuration, or
    the JAX dry run's at `world` ranks."""
    if full_width:
        return dict(encoder_type="small", image_size=128, num_envs=16, batch_size=256,
                    utd_ratio=4, updates_per_iter=2, training_starts=0, random_steps=0,
                    buffer_capacity=10_000)
    return dict(encoder_type="small", image_size=32, num_envs=world, batch_size=world,
                utd_ratio=1, updates_per_iter=1, training_starts=0, random_steps=0,
                buffer_capacity=world * 32)


def build_program(name: str, dp, device, world: int, full_width: bool,
                  overrides: Optional[dict] = None):
    """(carry, run_chunk, info) of program `name` on this rank: the carry
    built at the global size from seed 0 and, with `dp`, cut to the rank's
    share. info: num_envs (global), the env, the ring spec, the agents,
    and the learner's row threshold."""
    from serl_tpu_torch.distributed.sharding import shard_carry, shard_chained_carry
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment, make_state_sim_experiment

    overrides = dict(overrides or {})
    if name in ("state", "pixels"):
        if name == "state":
            kw = {**state_config(world, full_width), **overrides}
            env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
                seed=0, device=device, dp=dp, **kw)
        else:
            kw = {**pixel_config(world, full_width), **overrides}
            env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
                seed=0, device=device, dp=dp, **kw)
        carry = init_fn(agent, 0)
        if dp is not None:
            carry = shard_carry(carry, dp)
        threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
        return carry, run_chunk, {"num_envs": config.num_envs, "env": env, "rb": rb,
                                  "agents": (agent,), "config": config, "threshold": threshold,
                                  "rings": ("rb_state",)}
    if name != "fwbw":
        raise ValueError(f"unknown program {name!r}: want one of {PROGRAMS}")
    from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer
    from serl_tpu_torch.envs.chained_bin import ChainedBinEnv
    from serl_tpu_torch.examples import fused_fwbw_bin_relocation as ex
    from serl_tpu_torch.training.fwbw import FwBwConfig, make_chained_loop
    from serl_tpu_torch.training.launcher import make_sac_agent

    if full_width:
        argv = FWBW_RECIPE + ["--device", str(device)]
        for k, v in overrides.items():
            argv += [f"--{k}", str(v)]
        args = ex.parser().parse_args(argv)
        with contextlib.redirect_stdout(sys.stderr):
            (env, _, rb, config, fw, bw, init_fn, run_chunk, demos,
             _) = ex.build(args, sys.stderr, dp=dp)
        fw_demo, bw_demo, demo_rb = demos
        carry = init_fn(fw, bw, args.seed, fw_demo=fw_demo, bw_demo=bw_demo, demo_rb=demo_rb)
    else:
        config = FwBwConfig(**{**dict(envs_per_task=world, batch_size=2 * world, utd_ratio=2,
                                      training_starts=0, random_steps=0,
                                      buffer_capacity=2 * world * 32), **overrides})
        env = ChainedBinEnv(dense_shaping=False, fresh_reset_prob=0.3, device=device)
        example = {"observations": torch.zeros((13,)), "actions": torch.zeros((7,)),
                   "next_observations": torch.zeros((13,)), "rewards": torch.zeros(()),
                   "masks": torch.zeros(()), "dones": torch.zeros(())}
        rb = RoutedReplayBuffer(example, capacity=config.buffer_capacity, device=device)
        fw = make_sac_agent(0, obs_dim=13, action_dim=7, device=device)
        bw = make_sac_agent(1, obs_dim=13, action_dim=7, device=device)
        init_fn, run_chunk = make_chained_loop(env, rb, config, dp=dp)
        carry = init_fn(fw, bw, 0)
    if dp is not None:
        carry = shard_chained_carry(carry, dp)
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio, 1)
    return carry, run_chunk, {"num_envs": 2 * config.envs_per_task, "env": env, "rb": rb,
                              "agents": (fw, bw), "config": config, "threshold": threshold,
                              "rings": ("fw_rb", "bw_rb")}


def assert_layout(name: str, carry, info: dict, dp) -> List[str]:
    """The counterparts of `_assert_layout` / `_assert_fwbw_layout`: env rows
    N / n, ring streams (and routed cursors) of the rank, replicated state."""
    from serl_tpu_torch.distributed.sharding import _leaves

    n = info["num_envs"]
    local = n // dp.world_size
    for leaf in _leaves(carry.env_states) + _leaves(carry.obs):
        if leaf.shape[0] != local:
            raise AssertionError(f"{name}: an env leaf of {tuple(leaf.shape)} on rank "
                                 f"{dp.rank}, want {local} rows")
    for ring_name in info["rings"]:
        ring = getattr(carry, ring_name)
        for leaf in _leaves(ring.data) + [ring.ep_id]:
            if leaf.shape[1] != local:
                raise AssertionError(f"{name}: {ring_name} holds {leaf.shape[1]} streams on "
                                     f"rank {dp.rank}, want {local}")
        if isinstance(ring.insert_slot, torch.Tensor):
            for cursor in (ring.insert_slot, ring.size):
                if tuple(cursor.shape) != (local,):
                    raise AssertionError(f"{name}: {ring_name}'s per-stream cursors have shape "
                                         f"{tuple(cursor.shape)}, want ({local},)")
    if any(agent.state.dp is not dp for agent in info["agents"]):
        raise AssertionError(f"{name}: an agent's gradients are not averaged over the ranks")
    return check_replicated(carry, info, dp)


def check_replicated(carry, info: dict, dp) -> List[str]:
    from serl_tpu_torch.distributed.sharding import replicated_digests

    digests = replicated_digests(dp, info["agents"], carry.rng)
    if len(set(digests)) != 1:
        raise AssertionError(f"params, optimizer state or generator differ across ranks: {digests}")
    return digests


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count (CUDA tensors only)."""
    from serl_tpu_torch.data import replay_buffer
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    return {"control_step": engine.control_step.launches,
            "render": rendering.render_cameras.launches,
            "random_crop": augmentations.crop_images.launches,
            "replay_gather": replay_buffer.gather_batch_aligned.launches,
            "dense_layer_norm_tanh_fwd": k5.dense_layer_norm_tanh_forward.launches,
            "dense_layer_norm_tanh_bwd": k5.dense_layer_norm_tanh_backward.launches}


class PhaseTrace:
    """Host seconds of the loop's phases, each outermost call between two
    device syncs: the env step, the sample, the update (its collectives,
    the exchange and the gradient all-reduces, apart)."""

    COLLECTIVES = ("all_to_all", "all_reduce")

    def __init__(self, device, dp):
        self.sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (
            lambda: None)
        self.dp = dp
        self.seconds = {"env_step": 0.0, "sample": 0.0, "update": 0.0,
                        "update_collectives": 0.0}

    def _collective_s(self) -> float:
        return sum(self.dp.seconds.get(op, 0.0) for op in self.COLLECTIVES) if self.dp else 0.0

    def traced(self, phase: str):
        def call(fn, *a, **kw):
            self.sync()
            t0, c0 = time.perf_counter(), self._collective_s()
            out = fn(*a, **kw)
            self.sync()
            self.seconds[phase] += time.perf_counter() - t0
            if phase == "update":
                self.seconds["update_collectives"] += self._collective_s() - c0
            return out

        return _outermost(call)

    def install(self, info: dict) -> None:
        _wrap(info["env"], "step_auto_reset", self.traced("env_step"))
        for obj, attr, phase in _learner_calls(info):
            _wrap(obj, attr, self.traced(phase))

    def reset(self) -> None:
        for k in self.seconds:
            self.seconds[k] = 0.0


def _outermost(call):
    """`call` for the outermost of nested calls (sample_mixed calls the
    ring's sample); a nested one runs its function plainly."""
    depth = [0]

    def outer(fn, *a, **kw):
        if depth[0]:
            return fn(*a, **kw)
        depth[0] += 1
        try:
            return call(fn, *a, **kw)
        finally:
            depth[0] -= 1

    return outer


def _wrap(obj, attr: str, call) -> None:
    """obj.attr(...) becomes call(the old obj.attr, ...)."""
    fn = getattr(obj, attr)
    setattr(obj, attr, lambda *a, **kw: call(fn, *a, **kw))


def _learner_calls(info: dict):
    """(object, method, phase) of the learner's calls: the ring's samples
    and each agent's update_high_utd (with its exchange)."""
    return ([(info["rb"], "sample", "sample"), (info["rb"], "sample_mixed", "sample")]
            + [(agent, "update_high_utd", "update") for agent in info["agents"]])


def _strict(fn, *a, **kw):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sync_free_learner(info: dict) -> None:
    """Run every later sample and update_high_utd of the program under
    torch.cuda.set_sync_debug_mode("error")."""
    strict = _outermost(_strict)
    for obj, attr, _ in _learner_calls(info):
        _wrap(obj, attr, strict)


def device_busy_ms(run, iters: int) -> float:
    """Device busy ms per iteration of `run(iters)`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time for the loop")
    return busy / iters


def first_update_iteration(info: dict) -> int:
    """The 0-based iteration in which the learner first updates: the state
    and pixel loops' gate on the ring's rows after the insert."""
    return max(math.ceil(info["threshold"] / info["num_envs"]), 1) - 1


def _named(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a tree of named tuples, dicts and tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree._asdict().items() if hasattr(tree, "_asdict") else
             tree.items() if isinstance(tree, dict) else ())
    return {k: v for name, sub in items for k, v in _named(sub, f"{prefix}/{name}").items()}


def _snapshot(carry, info: dict) -> dict:
    """CPU copies of the rank's env rows, obs and frame-stack history, its
    rings' fields, and its agents' learner state (`agent_tensors`)."""
    from serl_tpu_torch.distributed.sharding import agent_tensors

    def cpu(named):
        return {k: t.detach().cpu().clone() for k, t in named.items()}

    rings = {name: cpu({**_named(getattr(carry, name).data),
                        "/ep_id": getattr(carry, name).ep_id}) for name in info["rings"]}
    return {"env": cpu({**_named(carry.env_states), **_named(carry.obs, "/obs"),
                        **_named(getattr(carry, "chunk", None), "/chunk")}),
            "rings": rings,
            "agents": [[t.detach().cpu().clone() for t in agent_tensors(a)]
                       for a in info["agents"]]}


def act_in_chunks(agent, rows: int) -> None:
    """Make `agent.sample_actions` act on `rows` rows a call, in turn, with
    each chunk's rows of the noise: what a rank holding `rows` envs
    computes, in one process (the witness of the two-rank comparison)."""
    from serl_tpu_torch.distributed.sharding import _map

    fn = agent.sample_actions

    def sample_actions(observations, *, noise, **kw):
        n = noise.shape[0]
        return torch.cat([fn(_map(lambda x: x[i:i + rows], observations),
                             noise=noise[i:i + rows], **kw) for i in range(0, n, rows)])

    agent.sample_actions = sample_actions


def run_program(name: str, dp, device, world: int, full_width: bool,
                segments: Optional[Sequence[int]] = None, overrides: Optional[dict] = None,
                trace: bool = False, profile_iters: int = 0, snapshot_dir: Optional[str] = None,
                sync_free_from: Optional[int] = None, act_rows: Optional[int] = None) -> dict:
    """Program `name` on this rank (or alone, `dp` None, as the 1-rank run):
    built, then run in `segments` of iterations (at full width by default:
    until the learner gate opens, then FULL_WIDTH_ITERS[name]; else the JAX
    dry run's count), the layout checked after each segment. Returns the
    counts (collectives and kernel launches after the carry is placed), the
    metrics, the gate's iteration and, with `trace`, where the timed
    segments' time went; with `snapshot_dir` each segment's env rows, rings
    and learner state go to <dir>/<name>_r<rank>_s<segment>.pt. From
    segment `sync_free_from` on, the learner's steps (each sample, each
    update_high_utd with its exchange and all-reduces) run under
    torch.cuda.set_sync_debug_mode("error") (CUDA): a host sync there
    raises. The (form, E, M, K, D) of K5's calls after the carry is placed
    come back in "k5_shapes". With `act_rows` the policies act on that many
    rows a call (`act_in_chunks`)."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    device = torch.device(device)
    rank = 0 if dp is None else dp.rank
    t0 = time.perf_counter()
    carry, run_chunk, info = build_program(name, dp, device, world, full_width, overrides)
    build_s = time.perf_counter() - t0
    if act_rows is not None:
        for agent in info["agents"]:
            act_in_chunks(agent, act_rows)
    tracer = None
    if trace:
        tracer = PhaseTrace(device, dp)
        tracer.install(info)
    if dp is not None:
        dp.reset_counts()
    launches0 = kernel_launches()
    outer_log, k5.shape_log = k5.shape_log, set()
    history: List[dict] = []
    if segments is None:
        segments = ([first_update_iteration(info) + 1, FULL_WIDTH_ITERS[name]] if full_width
                    else [JAX_ITERS[name]])
    timed: Dict[str, float] = {"iters": 0, "seconds": 0.0}
    iters_done = 0
    for i, seg in enumerate(segments):
        if name == "fwbw" and full_width and i == 0:
            # the fwbw gates open on the routed rows: run until both have
            while carry.training != (True, True):
                carry, m = run_chunk(carry, 1)
                history.append(m)
                iters_done += 1
                if iters_done > MAX_GATE_ITERS:
                    raise AssertionError(f"fwbw: the gates did not open in {iters_done} "
                                         "iterations")
        else:
            if i == 1:  # the timed segments start: their share of the collectives' seconds
                if tracer is not None:
                    tracer.reset()
                seconds0 = dict(dp.seconds) if dp is not None else {}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if i == sync_free_from and device.type == "cuda":
                sync_free_learner(info)
            t1 = time.perf_counter()
            carry, m = run_chunk(carry, seg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if i > 0:
                timed["iters"] += seg
                timed["seconds"] += time.perf_counter() - t1
            history.append(m)
            iters_done += seg
        if dp is not None:
            digests = (assert_layout(name, carry, info, dp) if i == len(segments) - 1
                       else check_replicated(carry, info, dp))
        if snapshot_dir is not None:
            torch.save(_snapshot(carry, info), os.path.join(snapshot_dir,
                                                            f"{name}_r{rank}_s{i}.pt"))
    metrics = {k: torch.cat([h[k].reshape(len(h[k]), -1) for h in history]).cpu()
               for k in history[0]}
    learner_key = "critic_loss" if "critic_loss" in metrics else "fw/critic_loss"
    active = (metrics[learner_key] != 0).reshape(len(metrics[learner_key]), -1).any(1)
    gate_iter = int(active.nonzero()[0]) if bool(active.any()) else None
    n = info["num_envs"]
    if carry.env_steps != iters_done * n:
        raise AssertionError(f"{name}: env_steps {carry.env_steps} != {iters_done} x {n}")
    for agent in info["agents"]:
        if agent.state.step <= 0:
            raise AssertionError(f"{name}: a learner never stepped")
    result = {"program": name, "rank": rank, "world": world, "iters": iters_done,
              "env_steps": carry.env_steps, "agent_steps": [a.state.step for a in info["agents"]],
              "gate_iter": gate_iter, "build_s": build_s, "metrics": metrics,
              "config": info["config"]._asdict(), "segments": list(segments),
              "bc": any(a.config.bc_regularization > 0 for a in info["agents"]),
              "launches": {k: v - launches0[k] for k, v in kernel_launches().items()},
              "k5_shapes": sorted(k5.shape_log),
              "collectives": {} if dp is None else {k: dict(v) for k, v in dp.counts.items()},
              "collective_s": {} if dp is None else dict(dp.seconds)}
    if name == "fwbw":
        routed = int(metrics["fw_rows"][-1]) + int(metrics["bw_rows"][-1])
        if routed != iters_done * n:
            raise AssertionError(f"fwbw: {routed} routed rows over the ranks, want "
                                 f"{iters_done} x {n}: each transition must route once")
        result["routed_rows"] = routed
    if dp is not None:
        result["digest"] = digests[0]
    if tracer is not None and timed["iters"]:
        per = 1e3 / timed["iters"]
        s = tracer.seconds
        exchange = reduce_all = 0.0
        if dp is not None:
            exchange = dp.seconds.get("all_to_all", 0.0) - seconds0.get("all_to_all", 0.0)
            reduce_all = dp.seconds.get("all_reduce", 0.0) - seconds0.get("all_reduce", 0.0)
        result["split_ms"] = {
            "iteration": timed["seconds"] * per, "env_step": s["env_step"] * per,
            "sample": s["sample"] * per, "exchange": exchange * per,
            "update_compute": (s["update"] - s["update_collectives"]) * per,
            "all_reduce": reduce_all * per}
        result["split_note"] = ("host clock with a device sync around each traced phase; the "
                                "exchange and all-reduce are the collectives' host seconds over "
                                "the timed segments (the all-reduces include the statistics')")
    k5.shape_log = outer_log
    if profile_iters and device.type == "cuda":
        holder = {"carry": carry}

        def run(k):
            holder["carry"], _ = run_chunk(holder["carry"], k)

        result["device_busy_ms_per_iter"] = device_busy_ms(run, profile_iters)
    return result


# ---------------------------------------------------------------- ranks


def check_backend(device: str, backend: str, nproc: int) -> None:
    """Raise where the device and backend cannot run `nproc` ranks: no
    silent switch between backends or devices."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device must be cpu or cuda, got {device!r}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"--backend must be gloo or nccl, got {backend!r}")
    if device == "cpu" and backend != "gloo":
        raise ValueError("--device cpu runs over the gloo backend: pass --backend gloo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card: pass --device cpu to run on the "
                               "CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and nproc > cards:
            raise ValueError(f"nccl runs one rank a card: {nproc} ranks on {cards} card(s); pass "
                             "--backend gloo, with which ranks may share a card")


def rank_device(rank: int, device: str, backend: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else rank % torch.cuda.device_count())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nproc: int, device: str, backend: str, port: int, task, queue) -> None:
    """One rank: join the group, run `task(dp)` (a picklable callable), put
    (rank, "ok", result) or (rank, "error", traceback) on `queue`."""
    import torch.distributed as dist

    from serl_tpu_torch.distributed.sharding import init_data_parallel

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
        dp = init_data_parallel(rank, nproc, backend=backend,
                                init_method=f"tcp://localhost:{port}",
                                device=rank_device(rank, device, backend),
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = task(dp)
        finally:
            dist.destroy_process_group()
        # by value: tensors shared by file descriptor would not outlive this process
        buf = io.BytesIO()
        torch.save(result, buf)
        queue.put((rank, "ok", buf.getvalue()))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def launch(task, nproc: int, device: str, backend: str, port: Optional[int] = None,
           timeout_s: float = 3600.0) -> List:
    """Run `task(dp)` on `nproc` spawned ranks; returns their results by
    rank. Raises, after stopping every rank, if one fails or the run
    outlasts `timeout_s`."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    check_backend(device, backend, nproc)
    port = port or free_port()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, nproc, device, backend, port, task, queue))
             for r in range(nproc)]
    for p in procs:
        p.start()
    results, errors = [None] * nproc, []
    deadline = time.monotonic() + timeout_s
    try:
        for _ in range(nproc):
            try:
                rank, status, payload = queue.get(timeout=max(deadline - time.monotonic(), 1.0))
            except queue_mod.Empty:
                errors.append(f"no result from every rank within {timeout_s:.0f} s")
                break
            if status == "ok":
                results[rank] = torch.load(io.BytesIO(payload), weights_only=False)
            else:
                errors.append(f"rank {rank} failed:\n{payload}")
                break
    finally:
        if errors:
            for p in procs:
                p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise RuntimeError(f"data-parallel run failed (exit codes {codes}): "
                           + ("\n".join(errors) or "a rank exited without its result"))
    return results


class Programs:
    """A rank's task: the named programs in turn (`run_program`'s keywords
    per program in `kwargs`)."""

    def __init__(self, names: Sequence[str], device: str, full_width: bool, **kwargs):
        self.names, self.device, self.full_width, self.kwargs = names, device, full_width, kwargs

    def __call__(self, dp):
        return [run_program(name, dp, dp.device, dp.world_size, self.full_width,
                            **self.kwargs.get(name, {})) for name in self.names]


def ok_line(result: dict) -> str:
    n, it = result["world"], result["iters"]
    line = f"dryrun {result['program']} OK: {n} ranks, {it} iters, env_steps={result['env_steps']}"
    if result["program"] == "state":
        line += f", agent_step={result['agent_steps'][0]}"
    if result["program"] == "fwbw":
        line += f", routed_rows={result['routed_rows']}"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--full_width", action="store_true")
    p.add_argument("--programs", default=",".join(PROGRAMS))
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    names = [n for n in args.programs.split(",") if n]
    for name in names:
        if name not in PROGRAMS:
            raise ValueError(f"unknown program {name!r}: want one of {PROGRAMS}")
    t0 = time.perf_counter()
    results = launch(Programs(names, args.device, args.full_width), args.nproc, args.device,
                     backend, args.port)
    for per_program in zip(*results):
        print(ok_line(per_program[0]), flush=True)
    print(f"dryrun_multichip OK: {args.nproc} ranks ({' + '.join(names)}; {backend} on "
          f"{args.device}) in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
