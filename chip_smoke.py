#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (serl_tpu_torch) runs on one GPU.

    python3 chip_smoke.py              # every phase, and the result lines
    python3 chip_smoke.py --kernels    # phases 1 and 2 and K5's times only

Phases, each fatal (non-zero exit, no result line) on failure:
  1. device: the card's name and power limit; build the CUDA kernels from the
     sources in this checkout, one nvcc per source started together (K1, the
     control step, serl_tpu_torch/csrc/control_step.cu; K2, the renderer,
     csrc/render.cu, and a second build of it with the other -fmad flag; K3,
     the random crop, csrc/random_crop.cu; K4, the replay gather,
     csrc/replay_gather.cu; K5, Dense + LayerNorm + tanh forward and
     backward, csrc/dense_layer_norm_tanh.cu) while g++ builds K1's and K2's
     code for the host to count their operations (tests/k1_host.cpp,
     tests/k2_host.cpp); print the build times and ptxas lines;
  2. every kernel against its plain version on the card: K1 at N = 128,
     2048 and 101 (not a multiple of the envs per block) env states from two
     sources (a plain-version rollout with random actions, and constructed
     grasp states with the cube between the pads), which must include active
     floor and pad contacts: one control step, field by field and env by env,
     and a 100-step kernel-vs-plain rollout, under the tolerance rule of
     tests/torch_k1.py; two more launches on each input, and at N = 2048 a
     launch on its first 101 envs, equal bit for bit; K2 (both -fmad builds)
     at N = 16 and 128, 128 px, on rollout and grasp states (cube in the
     wrist camera's view) under the pixel rule of tests/torch_k2.py (failing
     the phase for the shipped build only), its scene rows (the kernel's
     debug output) within tests/torch_k2.py's SCENE_ATOL of pack_scene's,
     and one render under torch.cuda.set_sync_debug_mode("error"); K3 at
     (1024, 1, 128, 128, 3) and (1024, 3, 128, 128, 3), four image batches
     per launch, and at K3_PATHS, which reach its word and byte paths
     (frames 4 bytes off, 252- and 33-byte rows) and float frames: exactly
     equal; K4 at the state path's shapes (782 slots x 128 streams, 2048
     rows, next_observations stored and not) and at the pixel path's (625 x
     16, 1024 rows of 128 px frames, frame stacks T = 1 and 3), on wrapped
     rings with episode boundaries and the seam, and on fields that reach
     each of its copy paths (16-byte, word and byte units, wide and narrow
     rows, a base address 4 bytes off): exactly equal; K5 forward
     and backward at every (E, M, K, D) of K5_SHAPES under the rule of
     tests/torch_k5.py, its weight-grad sums repeating bit for bit;
  3. the actor path: make_state_sim_experiment with 128 envs and the
     full-width networks, 20 loop iterations (8 random, 12 policy) and a
     128-episode evaluate; the state learner path: bench.py::bench_state's
     configuration (128 envs, UTD 8, batch 256, 10 critics subsampled to 2,
     buffer 100,000) warmed up past its training threshold, then 3 chunks of
     50 iterations timed as bench.py does (best of 3, ending in a sync), then
     a 128-episode evaluate; the pixel learner path: bench.py::bench_pixels'
     configuration through make_drq_sim_experiment (16 envs, two 128 px
     cameras, small encoders, UTD 4, batch 256, 2 updates per iteration,
     buffer 10,000) warmed up in chunks of 25 past its threshold, then 3
     chunks of 25 timed, then a 16-episode evaluate. Around each path every
     launch count is read and checked against the count that its loss
     functions and loop give; outputs must be finite and non-zero and the
     params must move;
  4. times on the card: each kernel and its plain version at its path's
     shapes (calls back to back between one pair of CUDA events, and the
     kernel's device time from torch.profiler; K4's pixel gather also with
     L2 flushed before each call) beside its bound (K1 also beside its
     critical path and ptxas's registers and spills; K2 beside its
     operations per pixel, per (env, camera) and per env, the unhoisted
     count, and the device time of both -fmad builds), K5 also
     beside the torch sequence it replaced (Dense, bias, tanh(layer_norm),
     and that sequence's autograd backward), per call and on the device, where an
     actor step's, a state learner iteration's and a pixel iteration's time
     go, the learner steps run under torch.cuda.set_sync_debug_mode("error"),
     and the device busy share of the loops (torch.profiler). A trace that
     records no device time for a kernel it times, or a loop's window in
     which a kernel of that path has none, fails the phase.
It prints the kernel table as one JSON line, then the card's name and power
limit, and last {"ok": true, "device": {...}}. It needs one CUDA card and the
repository around it (serl_tpu_torch/, tests/torch_k1.py, tests/torch_k2.py,
tests/torch_k5.py); it never imports JAX or serl_tpu.
"""

import ctypes
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, dense TF32 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
BOUND_N = (128, 2048)
K1_ODD_N = 101  # not a multiple of K1's envs per block (control_step.cu)
MAIN_ENVS = 128
# bench.py::bench_state's configuration, passed to make_state_sim_experiment
BENCH_STATE = dict(seed=0, num_envs=128, updates_per_iter=1, utd_ratio=8, training_starts=1000,
                   random_steps=1000, buffer_capacity=100_000)
CHUNK = 50  # loop iterations per timed chunk, as bench_state
K4_SHAPE = dict(slots=782, streams=128, rows_per_stream=16)  # 100,096 rows, batch 2048
K4_PIXEL_SHAPE = dict(slots=625, streams=16, rows_per_stream=64)  # 10,000 rows, batch 1024
# bench.py::bench_pixels' configuration, passed to make_drq_sim_experiment
BENCH_PIXELS = dict(seed=0, encoder_type="small", num_envs=16, batch_size=256, utd_ratio=4,
                    updates_per_iter=2, training_starts=0, random_steps=0,
                    buffer_capacity=10_000)
PIXEL_CHUNK = 25  # loop iterations per timed chunk, as bench_pixels
PIXEL_SIZE = 128
IMAGE_KEYS = ("front", "wrist")
K2_N = (16, 128)
K2_KERNELS = ("render_scene_kernel", "render_pixels_kernel")  # a render launches both
# K2's two builds, the shipped one (nvcc's default flags) first: (label,
# extra nvcc flags)
K2_BUILDS = (("-fmad=true", None), ("-fmad=false", ("-fmad=false",)))
K3_SHAPES = ((1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3), (1024, 3, PIXEL_SIZE, PIXEL_SIZE, 3))
# K3's other copy paths: (shape, dtype, base bytes past 16-byte alignment,
# images per launch, the unit the kernel must take)
K3_PATHS = (
    ((1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "uint8", 4, 2, 4),  # frames 4 bytes off: words
    ((1024, 1, 84, 84, 3), "uint8", 0, 2, 4),                  # 252-byte rows: words
    ((256, 1, 33, 33, 1), "uint8", 0, 2, 1),                   # 33-byte rows: bytes
    ((256, 1, PIXEL_SIZE, PIXEL_SIZE, 3), "float32", 0, 2, 16),  # float frames
)
# K5's calls on the main paths, (form, E, M, K, D) -> (whether that call's
# backward computes the weight grads, dgamma, dbeta, dbias and dW: not in
# the actor loss's pass through the critic's constants; whether it needs
# dx: not where x is an observation or a replayed action). Forms: "shared",
# one x through the E members of the ensemble's first layer; "member", an x
# per member; "linear", one nn.Linear weight.
K5_SHAPES = {
    ("shared", 10, 256, 14, 256): (True, False),   # state critic, layer 1 (obs 10 + action 4)
    ("member", 10, 256, 256, 256): (True, True),   # critic, layer 2
    ("member", 10, 2048, 256, 256): (False, True),  # the actor update's pass through the critic
    ("linear", 1, 2048, 10, 256): (True, False),   # state policy, layer 1, actor update
    ("linear", 1, 2048, 256, 256): (True, True),   # policy, layer 2
    ("shared", 10, 256, 580, 256): (True, True),   # pixel critic, layer 1 (2 x 256 + 64 + 4)
    ("linear", 1, 256, 7, 64): (True, False),      # pixel proprio Dense
    ("linear", 1, 256, 256, 256): (True, True),    # pixel bottleneck, per camera
}
K5_MAIN = ("member", 10, 256, 256, 256)  # the shape of most K5 launches: the critic updates
# K5's float operations per output element outside the product, counted in
# its kernels' code (the per-row divisions and square root left out):
# forward 15 (bias 1, mean sum 1, variance 3, centre, scale and shift 4,
# tanh by exp 6); backward 14 (g 3, x_hat 2, g*gamma 1, the two row sums 3,
# dh 5), plus 4 for the weight grads' column sums. The product itself is
# 2 * K per element, three times over in 3xTF32 on the tensor cores.
K5_OPS_PER_ELEMENT = {"fwd": 15, "bwd": 14, "bwd_weight_grads": 4}

# Launches per learner-loop iteration, from the loss functions
# (serl_tpu_torch/agents/sac.py). The policy MLP and the critic EnsembleMLP
# each run 2 Dense+LayerNorm+tanh (K5) layers per forward pass.
#   critic update (x utd_ratio): next actions from the policy (2 fwd, no
#     grad), the target critic (2 fwd, no grad), the critic (2 fwd) and its
#     backward (2 bwd): 6 fwd, 2 bwd;
#   actor+temperature update: the policy (2 fwd) and the critic on detached
#     params (2 fwd), backward through both (4 bwd, the critic's without
#     weight grads); the temperature loss's next actions (2 fwd, no grad):
#     6 fwd, 4 bwd;
#   acting: one policy sample (2 fwd), all iterations being past random_steps.
# One sample (1 K4 launch) and one control step (1 K1 launch) per iteration.
def learner_launches_per_iter(utd_ratio: int, updates_per_iter: int = 1) -> dict:
    return {"control_step": 1, "render": 0, "random_crop": 0,
            "replay_gather": updates_per_iter,
            "dense_layer_norm_tanh_fwd": updates_per_iter * (6 * utd_ratio + 6) + 2,
            "dense_layer_norm_tanh_bwd": updates_per_iter * (2 * utd_ratio + 4)}


# The actor path (phase 3): 20 control steps + 100 evaluate steps of K1; 2
# K5 forwards per policy call: 12 policy iterations + 100 evaluate steps.
ACTOR_LAUNCHES = {"control_step": 120, "render": 0, "random_crop": 0, "replay_gather": 0,
                  "dense_layer_norm_tanh_fwd": 2 * (12 + 100), "dense_layer_norm_tanh_bwd": 0}


# Launches per pixel-loop iteration (DrQ, serl_tpu_torch/agents/{drq,sac}.py).
# An ObsEncoder pass runs 3 K5 forwards: one bottleneck Dense+LayerNorm+tanh
# per camera and the proprio's; a policy or critic MLP pass runs 2.
#   critic update (x utd_ratio): next actions (encode 3 + policy 2, no
#     grad), the target critic on next_obs (target encoder 3 + critic 2, no
#     grad), the critic on obs (encoder 3 + critic 2) and its backward
#     through the critic (2) and the encoder (3), all with weight grads:
#     15 fwd, 5 bwd;
#   actor+temperature update: the policy (encode 3 under no_grad + policy 2),
#     the critic on detached params (encode 3 + critic 2), backward through
#     the critic (2, no weight grads) and the policy (2, weight grads); the
#     temperature loss's next actions (encode 3 + policy 2): 15 fwd, 4 bwd;
#   acting: one policy sample (encode 3 + policy 2), random_steps being 0.
# Per update_high_utd one sample (K4) and one crop launch (K3: obs and
# next_obs of both cameras); per iteration one control step (K1) and one
# render (K2: the post-reset observation; the terminal one is not rendered,
# as the pixel buffer does not store next observations), which launches two
# kernels: the scene, then the pixels.
def pixel_launches_per_iter(utd_ratio: int, updates_per_iter: int) -> dict:
    return {"control_step": 1, "render": 2, "random_crop": updates_per_iter,
            "replay_gather": updates_per_iter,
            "dense_layer_norm_tanh_fwd": updates_per_iter * (15 * utd_ratio + 15) + 5,
            "dense_layer_norm_tanh_bwd": updates_per_iter * (5 * utd_ratio + 4)}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_checks(name: str = "torch_k1"):
    """tests/<name>.py (torch_k1 or torch_k2), loaded by its path (a package
    named `tests` that is installed elsewhere must not shadow it)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fmt(d: dict) -> str:
    return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})


# ---------------------------------------------------------------- measuring


def per_call_ms(fn, calls: int, repeats: int = 5) -> float:
    """Time per call of fn: `calls` calls back to back between one pair of
    CUDA events, after one warm-up call; the median over `repeats`. The host
    queues K1's launches faster than the card runs them, so for K1 this is
    device time; for the plain version it is what a call costs in all."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def profiled_kernel_ms(fn, calls: int, kernels):
    """Device time per call of fn spent in kernels whose names contain one
    of `kernels` ("" for every kernel), from a torch.profiler trace of
    `calls` calls; raises when three traces record no device time for them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    for _ in range(3):  # a trace now and then records no device time: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and any(k in e.key for k in kernels)]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            return total_us / 1e3 / calls
    raise AssertionError(f"torch.profiler recorded no device time for kernels {kernels}")


def busy_share(torch, run, iters: int):
    """(wall ms unprofiled, device busy ms, {kernel name: ms}, {host op name:
    device ms of the kernels it launched}) of `run(iters)`: kernel time from
    a torch.profiler trace of the same number of iterations that a host
    clock times unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(iters)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
        torch.cuda.synchronize()
    events = prof.key_averages()
    by_name = {e.key: e.self_device_time_total / 1e3 for e in events
               if e.device_type == DeviceType.CUDA}
    by_op = {e.key: getattr(e, "device_time_total", 0.0) / 1e3 for e in events
             if e.device_type == DeviceType.CPU and e.key.startswith("aten::")}
    return wall_ms, sum(by_name.values()), by_name, by_op


def bound(bytes_moved: float, ops: float, tf32_ops: float = 0.0):
    """(bound ms, what bounds it) on an H100 SXM at its data-sheet rates:
    `ops` fp32 operations on the CUDA cores, `tf32_ops` on the tensor cores
    (the two units may overlap, so the larger of their times counts)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_FP32_OPS_PER_S, tf32_ops / PEAK_TF32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def launch_counters():
    """Every kernel wrapper of the port, by the kernel's name in the counts;
    each counts its launches in `.launches`."""
    from serl_tpu_torch.data import replay_buffer
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    return {"control_step": engine.control_step,
            "render": rendering.render_cameras,
            "random_crop": augmentations.crop_images,
            "replay_gather": replay_buffer.gather_batch_aligned,
            "dense_layer_norm_tanh_fwd": k5.dense_layer_norm_tanh_forward,
            "dense_layer_norm_tanh_bwd": k5.dense_layer_norm_tanh_backward}


def reset_launches() -> None:
    for wrapper in launch_counters().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in launch_counters().items()}


# ---------------------------------------------------------------- phases


def phase_kernel_vs_plain(torch, engine, checks, device):
    g = torch.Generator(device=device).manual_seed(0)
    main_path_err = 0.0
    for n in BOUND_N + (K1_ODD_N,):
        for source, make in (("rollout", checks.rollout_states), ("grasp", checks.grasp_states)):
            s = make(n, g, device)
            floor, pad = engine.active_contacts(s)
            n_floor, n_pad = int(floor.sum()), int(pad.sum())
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s)
            # two more launches on the same input; at N = 2048 also the first
            # K1_ODD_N envs alone (a partial block), against the same envs'
            # outputs of the whole launch
            first, second = engine.control_step_cuda(s), engine.control_step_cuda(s)
            repeats = all(torch.equal(a, b) for a, b in zip(first, second))
            if n == BOUND_N[-1]:
                part = engine.control_step_cuda(type(s)(*(x[:K1_ODD_N] for x in s)))
                repeats = repeats and all(torch.equal(a, b[:K1_ODD_N]) for a, b in zip(part, first))
            print(f"K1 vs plain, N={n}, {source} states: active floor corners {n_floor}, "
                  f"active pad points {n_pad}; max abs err {fmt(summary['max_err'])}; envs "
                  f"beyond the tight tolerance {summary['envs_over_atol']} (at most "
                  f"{summary['budget']}); two more launches on the same input"
                  + (f" and a launch on its first {K1_ODD_N} envs" if n == BOUND_N[-1] else "")
                  + f" equal bit for bit: {repeats}")
            if failures:
                raise AssertionError(f"N={n} {source}: " + "; ".join(failures))
            if not repeats:
                raise AssertionError(f"N={n} {source}: K1 launches on one input differ")
            if n == MAIN_ENVS:
                main_path_err = max(main_path_err, max(summary["max_err"].values()))
            if source == "rollout" and n_floor == 0:
                raise AssertionError(f"no active floor contact in the N={n} rollout states")
            if source == "grasp" and n_pad == 0:
                raise AssertionError(f"no active pad contact in the N={n} grasp states")
    print("K1 vs plain: env e's field f may differ by min(STEP_ATOL[f] + 3 x spread[e, f], "
          "STEP_CAP[f]) (spread: plain float32 vs float64 on the same state); at most N // 100 "
          f"envs may exceed STEP_ATOL; STEP_ATOL {fmt(checks.STEP_ATOL)}; STEP_CAP "
          f"{fmt(checks.STEP_CAP)}")

    # 100-step kernel-vs-plain rollout with the same random actions, beside a
    # float64 plain rollout that measures float32 rounding's own drift
    n = MAIN_ENVS
    sk = sp = checks.reset_states(n, g, device)
    s64 = checks.to_f64(sp)
    drift = {f: torch.zeros(n, dtype=torch.float64, device=device) for f in checks.DRIFT_ATOL}
    spread = {f: torch.zeros_like(v) for f, v in drift.items()}

    def track(acc, a, b):
        errs = checks.per_env_errors(a, b)
        errs["tcp_pos"] = (engine.observe(a)[0].double()
                           - engine.observe(b)[0].double()).abs().amax(1)
        for f in acc:
            acc[f] = torch.maximum(acc[f], errs[f])

    for _ in range(100):
        a = 2.0 * torch.rand((n, 4), generator=g, device=device) - 1.0
        sk = engine.control_step_cuda(checks.apply_action(sk, a))
        sp = engine.control_step_plain(checks.apply_action(sp, a))
        s64 = engine.control_step_plain(checks.apply_action(s64, a.double()))
        track(drift, sk, sp)
        track(spread, sp, s64)
    failures, summary = checks.judge(drift, spread, checks.DRIFT_ATOL, checks.DRIFT_CAP)
    print(f"K1 vs plain, 100-step rollout at N={n}: max drift {fmt(summary['max_err'])}; plain "
          f"float32-vs-float64 drift {fmt({f: float(v.max()) for f, v in spread.items()})}; envs "
          f"beyond DRIFT_ATOL {fmt(checks.DRIFT_ATOL)}: {summary['envs_over_atol']} (at most "
          f"{summary['budget']}); DRIFT_CAP {fmt(checks.DRIFT_CAP)}")
    if failures:
        raise AssertionError("100-step rollout: " + "; ".join(failures))
    return main_path_err


def phase_k4_vs_plain(torch, device):
    """K4 against its plain version at the main path's shapes: a full ring
    that has wrapped (cursor mid-ring), 100-step episodes that end at
    another slot in every stream, next_observations stored and not."""
    from serl_tpu_torch.data import replay_buffer as rbm

    slots, streams, r = K4_SHAPE["slots"], K4_SHAPE["streams"], K4_SHAPE["rows_per_stream"]
    g = torch.Generator(device=device).manual_seed(4)
    data = {k: torch.randn((slots, streams) + shape, generator=g, device=device)
            for k, shape in (("observations", (10,)), ("actions", (4,)),
                             ("next_observations", (10,)), ("rewards", ()), ("masks", ()),
                             ("dones", ()))}
    insert_slot = 300  # slot 299 is the newest, 300 the oldest
    age = (torch.arange(slots, device=device) - insert_slot) % slots
    stream = torch.arange(streams, device=device)
    ep_id = (((age[:, None] + 7 * stream[None, :]) // 100) * streams + stream[None, :]).to(torch.int32)
    err, boundary_rows = 0.0, 0
    for store_next_obs in (True, False):
        fields = data if store_next_obs else {k: v for k, v in data.items()
                                              if k != "next_observations"}
        n_valid = slots if store_next_obs else slots - 1
        u = torch.randint(0, n_valid, (r, streams), generator=g, device=device)
        s2 = (insert_slot - slots + u) % slots
        s2[0] = (insert_slot - 1 - int(not store_next_obs)) % slots  # the ring's seam
        got = rbm.gather_batch_aligned_cuda(fields, ep_id, s2, store_next_obs)
        want = rbm.gather_batch_aligned_plain(fields, ep_id, s2, store_next_obs)
        torch.cuda.synchronize()
        for k in want:
            if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
                raise AssertionError(f"K4 differs from plain in {k} (store_next_obs="
                                     f"{store_next_obs})")
            err = max(err, float((got[k] - want[k]).abs().max()))
        if not store_next_obs:
            nxt = (s2 + 1) % slots
            boundary_rows = int((ep_id[nxt, stream] != ep_id[s2, stream]).sum())
    if boundary_rows == 0:
        raise AssertionError("K4 check sampled no episode-boundary row")
    print(f"K4 vs plain at {slots} slots x {streams} streams, {r * streams} rows, next_obs "
          f"stored and not ({boundary_rows} rows at an episode boundary): exactly equal")
    return err


def k5_label(shape) -> str:
    form, e, m, k, d = shape
    return f"{form} (E, M, K, D) = ({e}, {m}, {k}, {d})"


def phase_k5_vs_plain(torch, k5_checks, device):
    """K5 forward and backward against the plain versions at K5_SHAPES, under
    the rule of tests/torch_k5.py: the forward that stores what autograd
    needs and the one that does not; the backward with and without weight
    grads, its dgamma, dbeta and dbias repeating bit for bit."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    g = torch.Generator(device=device).manual_seed(5)
    worst = {}
    for shape in K5_SHAPES:
        form, e, m, k, d = shape
        x, kernel, bias, gamma, beta, dy = k5_checks.inputs(form, e, m, k, d, g, device)
        x3, w3, b2, _ = k5.member_views(x, kernel, bias, form == "member")
        out = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
        y_only = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta)
        py, ph, pmean, prstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
        grads = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        again = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        dh_only = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma,
                                                    need_weight_grads=False)
        torch.cuda.synchronize()
        errs, limits = k5_checks.forward_errors(x3, w3, b2, gamma, beta, *out)
        berrs, blimits = k5_checks.backward_errors(dy, py, ph, pmean, prstd, gamma, *grads)
        errs.update(berrs)
        limits.update(blimits)
        bad = k5_checks.failures(errs, limits)
        if not torch.equal(y_only[0], out[0]):
            bad.append("y of the forward without autograd differs from y with it")
        if not all(torch.equal(a, b) for a, b in zip(grads[1:], again[1:])):
            bad.append("dgamma, dbeta or dbias differ between two calls")
        if dh_only[1] is not None or not torch.equal(dh_only[0], grads[0]):
            bad.append("the backward without weight grads differs in dh or gave weight grads")
        print(f"K5 vs plain at {k5_label(shape)}: errors "
              f"{json.dumps({n: float(f'{v:.3g}') for n, v in errs.items()})} within limits "
              f"{json.dumps({n: float(f'{v:.3g}') for n, v in limits.items()})}; y without "
              "autograd, dh without weight grads: equal; dgamma, dbeta, dbias over two calls: "
              "bit for bit")
        if bad:
            raise AssertionError(f"K5 differs from plain at {k5_label(shape)}: {bad}")
        for name, v in errs.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def phase_actor_path(torch, device):
    from serl_tpu_torch.envs.panda_pick import STATE_OBS_DIM
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=0, device="cuda", num_envs=MAIN_ENVS, buffer_capacity=100_000,
        random_steps=1000, training_starts=10**9,
    )
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    carry, metrics = run_chunk(carry, 20)
    torch.cuda.synchronize()
    actor_s = time.perf_counter() - t0
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(2), num_episodes=128)
    torch.cuda.synchronize()
    launches = read_launches()

    print(f"actor path: 20 loop iterations (8 random, 12 policy) x {MAIN_ENVS} envs + "
          f"evaluate(num_episodes=128): launches {json.dumps(launches)}; actor "
          f"{20 * MAIN_ENVS / actor_s:.1f} env-steps/s (host clock, {actor_s:.3f} s); "
          f"eval {json.dumps(ev)}")
    if launches != ACTOR_LAUNCHES:
        raise AssertionError(f"expected launches {ACTOR_LAUNCHES} on the actor path, got {launches}")
    buf = carry.rb_state
    obs = buf.data["observations"][: buf.size]
    checks = {
        "buffer_size": int(metrics["buffer_size"][-1]) == 20 * MAIN_ENVS,
        "obs shape": tuple(obs.shape) == (20, MAIN_ENVS, STATE_OBS_DIM),
        "obs finite": bool(torch.isfinite(obs).all()),
        "next_obs finite": bool(torch.isfinite(buf.data["next_observations"][: buf.size]).all()),
        "rewards in [0, 1]": bool(((buf.data["rewards"][: buf.size] >= 0)
                                   & (buf.data["rewards"][: buf.size] <= 1)).all()),
        "actions in [-1, 1]": bool((buf.data["actions"][: buf.size].abs() <= 1).all()),
        "loop state finite": bool(torch.isfinite(carry.obs).all()),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"actor path output checks failed: {bad}")
    return launches, env, agent, carry, run_chunk


def phase_learner_path(torch, device, card):
    """bench_state's configuration end to end, timed as bench.py's
    _bench_fused times it: best of 3 chunks of CHUNK iterations, each ending
    in a device-to-host read of a metric."""
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(device="cuda",
                                                                           **BENCH_STATE)
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(6))
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = -(-threshold // config.num_envs)  # its last iteration runs the first update
    carry, m = run_chunk(carry, warmup)
    if int(m["buffer_size"][-1]) < threshold or float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    best, chunks = float("inf"), []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk, as bench.py's fetch
        best = min(best, time.perf_counter() - t0)
        chunks.append(m)
    launches = read_launches()
    iters = 3 * CHUNK
    per_iter = learner_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    want = {k: v * iters for k, v in per_iter.items()}
    env_steps_s = CHUNK * config.num_envs / best
    updates_s = CHUNK * config.updates_per_iter * config.utd_ratio / best
    print(f"learner path (bench_state: {json.dumps(BENCH_STATE)}, {warmup} warm-up iterations, "
          f"then 3 chunks of {CHUNK}): best chunk {best:.4f} s (host clock ending in a sync): "
          f"{env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic updates/s; launches over the "
          f"{iters} iterations {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the learner path, got {launches}")
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(7), num_episodes=128)
    metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    learner = {k: metrics[k] for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    checks = {
        "losses finite": all(bool(torch.isfinite(v).all()) for v in learner.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in learner.values()),
        "temperature > 0": bool((learner["temperature"] > 0).all()),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "targets finite": all(bool(torch.isfinite(p).all())
                              for p in agent.state.target_params["critic"]),
        "params moved": all(not torch.equal(p, q) for p, q in zip(params, before)),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    print(f"learner path outputs: critic_loss {float(learner['critic_loss'][-1]):.5g}, "
          f"actor_loss {float(learner['actor_loss'][-1]):.5g}, temperature "
          f"{float(learner['temperature'][-1]):.5g}, entropy {float(learner['entropy'][-1]):.5g} "
          f"(last iteration); optimizer steps {agent.state.step}; eval {json.dumps(ev)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"learner path output checks failed: {bad}")
    return launches, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best), \
        env, agent, rb, config, carry, run_chunk


def phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk):
    g = torch.Generator(device=device).manual_seed(3)
    rows = {}
    for n in BOUND_N:
        s = checks.rollout_states(n, g, device, steps=5)
        step = lambda: engine.control_step_cuda(s)
        ms = per_call_ms(step, calls=50)
        prof_ms = profiled_kernel_ms(step, calls=50, kernels="control_step_kernel")
        plain_ms = per_call_ms(lambda: engine.control_step_plain(s), calls=2, repeats=3)
        ops_per_env, path_per_env = checks.op_and_path_counts(s)
        ops = int(ops_per_env.sum())
        bytes_moved = 2 * sum(x.numel() * 4 for x in s) + engine.kernel_constants().nbytes
        bound_ms, bound_by = bound(bytes_moved, ops)
        rows[n] = dict(ms=ms, profiler_ms=prof_ms, plain_ms=plain_ms, ops=ops,
                       bytes=bytes_moved, bound_ms=bound_ms, bound_by=bound_by,
                       critical_path_ops=int(path_per_env.max()))
        print(f"K1 time, N={n}: kernel {ms:.4f} ms per launch (50 back to back, CUDA events; "
              f"torch.profiler kernel time {prof_ms:.4f} ms), plain {plain_ms:.3f} ms per control "
              f"step; bound {bound_ms:.6f} ms by {bound_by} ({ops} fp32 ops "
              f"= {ops_per_env.min()}-{ops_per_env.max()} per env, counted in the kernel's code "
              f"by tests/k1_host.cpp; {bytes_moved} bytes); critical path (per phase the most "
              f"ops of one lane, summed) {path_per_env.min()}-{path_per_env.max()} ops per env; "
              f"no single PyTorch call computes K1, so library_ms is null [{card}]")

    # where an actor step's time goes, at the main path's 128 envs (policy
    # phase); each call between its own CUDA events, so a call's host launch
    # time is included, as the loop pays it
    obs = carry.obs
    states = carry.env_states
    act = agent.sample_actions(obs, generator=carry.rng)
    parts = {
        "policy sample_actions": lambda: agent.sample_actions(obs, generator=carry.rng),
        "K1 control_step": lambda: engine.control_step_cuda(states.physics),
        "env step_auto_reset (K1 + obs, reward, reset)": lambda: env.step_auto_reset(
            states, act, generator=carry.rng),
        "obs (plain fk + pinch velocity)": lambda: env._obs(states),
        "reward (plain fk)": lambda: env._reward(states),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=20) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print(f"actor step at N={MAIN_ENVS}, ms per call (median of 20 single calls between CUDA "
          "events, host launch time included): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}) + f" [{card}]")
    print_busy_share(torch, "actor loop", run, card, ("K1", "K5"))
    return rows


def print_busy_share(torch, what: str, run, card: str, path_kernels, iters: int = 10) -> None:
    """The loop's device busy share over `iters` iterations; fails when the
    trace gives no device time to a kernel of `path_kernels` (K1 .. K5)."""
    wall_ms, busy_ms, by_name, by_op = busy_share(torch, run, iters)
    ours = {name: sum(ms for k, ms in by_name.items() if any(part in k for part in kernels))
            for name, kernels in (("K1", ("control_step_kernel",)), ("K2", K2_KERNELS),
                                  ("K3", ("random_crop_kernel",)),
                                  ("K4", ("replay_gather_kernel",)), ("K5", ("dense_ln_tanh_",)))}
    missing = [k for k in path_kernels if not ours[k] > 0]
    if not busy_ms > 0 or missing:
        raise AssertionError(f"{what}: torch.profiler recorded no device time for "
                             f"{missing or 'any kernel'} in {iters} iterations")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"{what}, {iters} iterations: wall {wall_ms:.2f} ms (host clock, unprofiled), device "
          f"busy {busy_ms:.3f} ms (torch.profiler), busy share {busy_ms / wall_ms:.4f}, idle "
          f"share {1 - busy_ms / wall_ms:.4f}; device ms of our kernels "
          f"{json.dumps({k: round(v, 4) for k, v in ours.items()})}; largest kernels "
          f"{json.dumps([(k[:60], round(v, 4)) for k, v in top])}; host ops by the device ms "
          f"of their kernels (nested ops count again) "
          f"{json.dumps([(k, round(v, 4)) for k, v in top_ops])} [{card}]")


def phase_learner_times(torch, device, card, agent, rb, config, carry, run_chunk):
    """K4 at the main path's shape, and where a learner iteration's time goes."""
    from serl_tpu_torch.data import replay_buffer as rbm

    g = torch.Generator(device=device).manual_seed(8)
    rows = {}
    # K4 on the learner's own ring (782 x 128, next_observations stored)
    buf = carry.rb_state
    batch = config.batch_size * config.utd_ratio
    s2 = (buf.insert_slot - buf.size
          + torch.randint(0, buf.size, (batch // config.num_envs, config.num_envs),
                          generator=g, device=device)) % buf.ep_id.shape[0]
    gather = lambda: rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, s2, True)
    width = sum(v[0, 0].numel() for v in buf.data.values())
    bytes_moved = 2 * batch * width * 4 + s2.numel() * 8
    bound_ms, bound_by = bound(bytes_moved, 0)
    rows["replay_gather"] = dict(
        ms=per_call_ms(gather, calls=50),
        profiler_ms=profiled_kernel_ms(gather, 50, "replay_gather_kernel"),
        plain_ms=per_call_ms(lambda: rbm.gather_batch_aligned_plain(buf.data, buf.ep_id, s2, True),
                             calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, library_ms=None)

    for key, row in rows.items():
        print(f"{key} time: kernel {row['ms']:.4f} ms per call (50 back to back, CUDA events; "
              f"torch.profiler kernel time {row['profiler_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, library null, bound {row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} "
              f"bytes) [{card}]")

    # where a learner iteration's time goes: single calls between CUDA events
    full = rb.sample(buf, batch, generator=g)
    mini = {k: v[: config.batch_size] for k, v in full.items()}
    parts = {
        "sample (K4)": lambda: rb.sample(buf, batch, generator=g),
        "critic update (1 of utd_ratio)": lambda: agent.update(
            mini, networks_to_update=frozenset({"critic"}), generator=g),
        "actor+temperature update": lambda: agent.update(
            full, networks_to_update=frozenset({"actor", "temperature"}), generator=g),
        "update_high_utd": lambda: agent.update_high_utd(full, utd_ratio=config.utd_ratio,
                                                         generator=g),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=10) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print("learner iteration, ms per call (median of 10 single calls between CUDA events, host "
          "launch time included): " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" [{card}]")
    # the learner's step never waits for the device: a synchronizing call
    # raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample(buf, batch, generator=g), utd_ratio=config.utd_ratio,
                              generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sample + update_high_utd ran under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync in the learner step")
    print_busy_share(torch, "learner loop", run, card, ("K1", "K4", "K5"))
    return rows


def phase_k5_times(torch, k5_checks, device, card):
    """K5 at each of K5_SHAPES: the kernels' wrappers, the plain versions,
    the op end to end (the forward through autograd; the backward with its
    two products), and the torch sequence the op replaced (the Dense as
    F.linear or matmul/bmm plus the bias, then tanh(F.layer_norm); its
    autograd backward), each per call (calls back to back between CUDA
    events) and on the device (torch.profiler: our kernel alone for the
    wrappers, every kernel for the op and the sequence)."""
    import torch.nn.functional as F

    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    g = torch.Generator(device=device).manual_seed(8)
    rows = {}
    for shape, (wg, need_dx) in K5_SHAPES.items():
        form, e, m, k, d = shape
        member = form == "member"
        x, kernel, bias, gamma, beta, dy = k5_checks.inputs(form, e, m, k, d, g, device)
        x3, w3, b2, out_shape = k5.member_views(x, kernel, bias, member)
        y, h, mean, rstd = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
        dy_out = dy.view(out_shape)

        def leaves():
            ts = [t.detach().clone().requires_grad_(need)
                  for t, need in zip((x, kernel, bias, gamma, beta), (need_dx,) + (wg,) * 4)]
            return ts, [t for t in ts if t.requires_grad]

        def sequence(xs, ks, bs, gs, bes):
            if form == "linear":
                hh = F.linear(xs, ks, bs)
            elif member:
                hh = torch.bmm(xs, ks) + bs[:, None, :]
            else:
                hh = torch.matmul(xs.reshape(1, -1, k), ks) + bs[:, None, :]
            return torch.tanh(F.layer_norm(hh, (d,), gs, bes, k5.LAYER_NORM_EPS))

        op_args, op_needed = leaves()
        op = lambda: k5.dense_layer_norm_tanh(*op_args, member_inputs=member)
        op_y = op()
        seq_args, seq_needed = leaves()
        seq = lambda: sequence(*seq_args)
        seq_y = seq()
        fwd_bytes = 4 * (x3.numel() + w3.numel() + b2.numel() + 2 * d + 2 * e * m * d + 2 * e * m)
        bwd_bytes = 4 * (4 * e * m * d + 2 * e * m + d + ((2 + e) * d if wg else 0))
        cases = {
            "fwd": dict(
                kernel=lambda: k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True),
                kernel_name="dense_ln_tanh_fwd_kernel",
                plain=lambda: k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta),
                op=op, sequence=seq, bytes=fwd_bytes,
                ops=K5_OPS_PER_ELEMENT["fwd"] * e * m * d, tf32_ops=3 * 2 * e * m * k * d),
            "bwd": dict(
                kernel=lambda: k5.dense_layer_norm_tanh_backward(dy, y, h, mean, rstd, gamma, wg),
                kernel_name="dense_ln_tanh_bwd_kernel",
                plain=lambda: k5.dense_layer_norm_tanh_backward_plain(dy, y, h, mean, rstd, gamma,
                                                                      wg),
                op=lambda: torch.autograd.grad(op_y, op_needed, dy_out, retain_graph=True),
                sequence=lambda: torch.autograd.grad(seq_y, seq_needed, dy_out,
                                                     retain_graph=True),
                bytes=bwd_bytes, tf32_ops=0,
                ops=(K5_OPS_PER_ELEMENT["bwd"] + wg * K5_OPS_PER_ELEMENT["bwd_weight_grads"])
                * e * m * d),
        }
        for direction, c in cases.items():
            bound_ms, bound_by = bound(c["bytes"], c["ops"], c["tf32_ops"])
            rows[(direction, shape)] = row = dict(
                ms=per_call_ms(c["kernel"], calls=50),
                profiler_ms=profiled_kernel_ms(c["kernel"], 50, c["kernel_name"]),
                plain_ms=per_call_ms(c["plain"], calls=20),
                op_ms=per_call_ms(c["op"], calls=50),
                op_profiler_ms=profiled_kernel_ms(c["op"], 50, ""),
                sequence_ms=per_call_ms(c["sequence"], calls=50),
                sequence_profiler_ms=profiled_kernel_ms(c["sequence"], 50, ""),
                bound_ms=bound_ms, bound_by=bound_by, bytes=c["bytes"],
                tf32_ops=c["tf32_ops"], fp32_ops=c["ops"], library_ms=None)
            what = ("y, h, mean, rstd stored" if direction == "fwd" else
                    "dh" + (", dgamma, dbeta, dbias" if wg else " only (as on the main path)"))
            print(f"K5 {direction} at {k5_label(shape)} ({what}): kernel {row['ms']:.4f} ms per "
                  f"call (50 back to back, CUDA events), {row['profiler_ms']:.4f} ms on the "
                  f"device (torch.profiler); plain {row['plain_ms']:.4f} ms; the op through "
                  f"autograd{' with its dx, dW products' if direction == 'bwd' else ''} "
                  f"{row['op_ms']:.4f} ms per call, {row['op_profiler_ms']:.4f} ms on the "
                  f"device; the replaced torch sequence {row['sequence_ms']:.4f} ms per call, "
                  f"{row['sequence_profiler_ms']:.4f} ms on the device; bound "
                  f"{row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} bytes, "
                  f"{row['tf32_ops']} TF32 tensor-core ops at 495 TFLOP/s, {row['fp32_ops']} "
                  f"fp32 ops at 67 TFLOP/s) [{card}]")
    return rows


def phase_k2_vs_plain(torch, checks, k2, builds, device):
    """K2 against its plain version at K2_N envs, 128 px, on rollout and
    grasp states, under the pixel rule of tests/torch_k2.py, both -fmad
    builds; the kernel's scene rows (its debug output) against pack_scene's;
    one render under torch.cuda.set_sync_debug_mode("error")."""
    from serl_tpu_torch.envs import rendering

    g = torch.Generator(device=device).manual_seed(2)
    worst, scene_err = 0, 0.0
    rule = {label: True for label in builds}
    shipped = next(iter(builds))
    for n in K2_N:
        for source, make in (("rollout", checks.rollout_states), ("grasp", checks.grasp_states)):
            s = make(n, g, device)
            want = rendering.render_cameras_plain(s, PIXEL_SIZE)
            for label, lib in builds.items():
                rows = torch.empty((n, rendering.SCENE_FLOATS), device=device)
                got = rendering.render_cameras_cuda(s, PIXEL_SIZE, scene_out=rows, lib=lib)
                torch.cuda.synchronize()
                err = float((rows - rendering.pack_scene(s)).abs().max())
                print(f"K2 ({label}) scene rows vs pack_scene, N={n}, {source} states: max abs "
                      f"err {err:.3g} (tolerance {k2.SCENE_ATOL})")
                if err > k2.SCENE_ATOL:
                    raise AssertionError(f"K2 ({label}) scene rows N={n} {source}: {err}")
                scene_err = max(scene_err, err)
                for cam, a, b in zip(IMAGE_KEYS, got, want):
                    failures, summary = k2.pixel_rule(a, b)
                    print(f"K2 ({label}) vs plain, N={n}, {source} states, {cam}: "
                          f"{json.dumps(summary)}")
                    rule[label] = rule[label] and not failures
                    if label == shipped:
                        if failures:
                            raise AssertionError(f"K2 N={n} {source} {cam}: " + "; ".join(failures))
                        worst = max(worst, summary["max_level_diff"])
            if source == "grasp":
                # the cube (purple: red = blue > green) is in the wrist camera's view
                w = want[1].to(torch.int16)
                cube = ((w[..., 0] - w[..., 2]).abs() <= 2) & (w[..., 0] > w[..., 1] + 10)
                envs = int(cube.flatten(1).any(1).sum())
                print(f"K2 grasp states at N={n}: the cube is in {envs} of {n} wrist frames")
                if envs < n // 2:
                    raise AssertionError(f"the cube is in view in only {envs} of {n} grasp frames")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rendering.render_cameras(s, PIXEL_SIZE)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"K2 vs plain: at most {k2.FLIP_SHARE:.3%} of the pixels may differ by more than one "
          f"level, each on an edge (3x3 span > {k2.EDGE_LEVELS} levels); worst level "
          f"difference {worst} (shipped build); the rule held for "
          f"{json.dumps(rule)}; scene rows within {scene_err:.3g} of pack_scene's; a render ran "
          "under torch.cuda.set_sync_debug_mode('error'): nothing copied from the host")
    return worst, scene_err, rule


def phase_k3_vs_plain(torch, device):
    """K3 against its plain version: four image batches per launch (obs and
    next_obs of both cameras, as DrQ crops them) at K3_SHAPES, and batches
    that reach each copy path of the kernel (K3_PATHS): exactly equal."""
    from serl_tpu_torch.vision import augmentations as aug

    g = torch.Generator(device=device).manual_seed(3)
    lib = aug._crop_library()
    cases = [(shape, torch.uint8, 0, 4, 16) for shape in K3_SHAPES] + [
        (shape, getattr(torch, dtype), off, jobs, unit) for shape, dtype, off, jobs, unit in K3_PATHS]
    for shape, dtype, base_offset, jobs, unit in cases:
        n = math.prod(shape)
        imgs = []
        for _ in range(jobs):
            raw = torch.randint(0, 256, (n * torch.tensor([], dtype=dtype).element_size()
                                         + base_offset,), generator=g, device=device,
                                dtype=torch.uint8)
            imgs.append(raw[base_offset:].view(dtype).view(shape))
        offs = [aug.crop_offsets(shape[0] * shape[1], 4, g, device) for _ in imgs]
        got = aug.crop_images(imgs, offs, padding=4, num_batch_dims=2)
        ptrs = lambda ts: (ctypes.c_void_p * jobs)(*(t.data_ptr() for t in ts))
        took = lib.serl_random_crop_unit(ptrs(imgs), ptrs(got), jobs, shape[3],
                                         shape[4] * imgs[0].element_size())
        if took != unit:
            raise AssertionError(f"K3 at {shape} {dtype} {base_offset} bytes off took "
                                 f"{took}-byte units, not {unit}")
        for img, off, out in zip(imgs, offs, got):
            want = aug.batched_random_crop_gather(img, off, padding=4, num_batch_dims=2)
            if not torch.equal(out.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"K3 differs from plain at {shape} {dtype}")
        print(f"K3 vs plain at {jobs} x {shape} {dtype}, base {base_offset} bytes past 16-byte "
              f"alignment, one launch, {unit}-byte units: exactly equal")
    return 0.0


def _pixel_ring(torch, device, g):
    """A full, wrapped ring at K4_PIXEL_SHAPE with 100-slot episodes that end
    at another slot in every stream: (data, ep_id, insert_slot)."""
    slots, streams = K4_PIXEL_SHAPE["slots"], K4_PIXEL_SHAPE["streams"]
    frame = (PIXEL_SIZE, PIXEL_SIZE, 3)
    data = {"observations": {"state": torch.randn((slots, streams, 7), generator=g, device=device),
                             **{k: torch.randint(0, 256, (slots, streams) + frame, generator=g,
                                                 device=device, dtype=torch.uint8)
                                for k in IMAGE_KEYS}},
            **{k: torch.randn((slots, streams) + shape, generator=g, device=device)
               for k, shape in (("actions", (4,)), ("rewards", ()), ("masks", ()), ("dones", ()))}}
    insert_slot = 300  # slot 299 is the newest, 300 the oldest
    age = (torch.arange(slots, device=device) - insert_slot) % slots
    stream = torch.arange(streams, device=device)
    ep_id = (((age[:, None] + 7 * stream[None, :]) // 100) * streams
             + stream[None, :]).to(torch.int32)
    return data, ep_id, insert_slot


def phase_k4_pixel_vs_plain(torch, device):
    """K4's pixel gather against its plain version at the pixel path's
    shapes: T = 1 and 3, rows at episode starts (clamped stacks), at episode
    ends (successor fallback) and at the ring's seam: exactly equal."""
    from serl_tpu_torch.data import replay_buffer as rbm

    slots, streams, r = (K4_PIXEL_SHAPE[k] for k in ("slots", "streams", "rows_per_stream"))
    g = torch.Generator(device=device).manual_seed(44)
    data, ep_id, insert_slot = _pixel_ring(torch, device, g)
    stream = torch.arange(streams, device=device)
    starts = ((ep_id != ep_id.roll(1, 0)).to(torch.int32).argmax(0))  # an episode's first slot
    u = torch.randint(0, slots - 1, (r, streams), generator=g, device=device)
    s2 = (insert_slot - slots + u) % slots
    s2[0] = (insert_slot - 2) % slots  # the seam: the newest sampleable slot
    s2[1], s2[2], s2[3] = starts, (starts + 1) % slots, (starts - 1) % slots
    for num_stack in (1, 3):
        got = rbm.gather_batch_aligned_cuda(data, ep_id, s2, False, IMAGE_KEYS, num_stack)
        want = rbm.gather_batch_aligned_plain(data, ep_id, s2, False, IMAGE_KEYS, num_stack)
        torch.cuda.synchronize()
        for part in want:
            for k, w in (want[part].items() if isinstance(want[part], dict) else [(None, want[part])]):
                x = got[part] if k is None else got[part][k]
                if x.shape != w.shape or x.dtype != w.dtype or not torch.equal(x, w):
                    raise AssertionError(f"K4 pixel differs from plain in {part}/{k} (T={num_stack})")
    raw = (s2[:, :, None] - torch.arange(2, -1, -1, device=device)) % slots
    clamped = int((ep_id[raw, stream[None, :, None]] != ep_id[s2, stream][..., None]).sum())
    boundary = int((ep_id[(s2 + 1) % slots, stream] != ep_id[s2, stream]).sum())
    if clamped == 0 or boundary == 0:
        raise AssertionError("K4 pixel check sampled no clamped stack or no episode end")
    print(f"K4 pixel vs plain at {slots} slots x {streams} streams, {r * streams} rows of "
          f"{PIXEL_SIZE} px frames, T = 1 and 3 ({clamped} clamped stack frames at T = 3, "
          f"{boundary} rows at an episode end): exactly equal")
    return 0.0


def phase_k4_copy_paths_vs_plain(torch, device):
    """K4 against its plain version on fields that reach every copy path of
    the kernel: wide rows (1024 bytes or more) in 16-byte units (aligned
    frames), in 4-byte words (frames whose base address is 4 bytes off, a
    contiguous view into a larger buffer) and in bytes (27 x 27 x 3 frames,
    2,187 bytes a row); narrow rows in words (fp32) and in bytes (a 27-byte
    uint8 field). T = 1 and 3, at the pixel path's ring shape: exactly equal."""
    from serl_tpu_torch.data import replay_buffer as rbm

    slots, streams, r = (K4_PIXEL_SHAPE[k] for k in ("slots", "streams", "rows_per_stream"))
    g = torch.Generator(device=device).manual_seed(45)

    def frames(shape, offset=0):
        n = slots * streams * math.prod(shape)
        flat = torch.randint(0, 256, (n + offset,), generator=g, device=device, dtype=torch.uint8)
        return flat[offset:].view((slots, streams) + shape)

    _, ep_id, insert_slot = _pixel_ring(torch, device, g)
    data = {"observations": {"state": torch.randn((slots, streams, 7), generator=g, device=device),
                             "bytes27": frames((27,)),
                             "aligned": frames((64, 64, 3)),
                             "off_by_4": frames((64, 64, 3), offset=4),
                             "odd": frames((27, 27, 3))},
            **{k: torch.randn((slots, streams) + shape, generator=g, device=device)
               for k, shape in (("actions", (4,)), ("rewards", ()), ("masks", ()), ("dones", ()))}}
    image_keys = ("aligned", "off_by_4", "odd")
    if data["observations"]["off_by_4"].data_ptr() % 16 != 4:
        raise AssertionError("the off-by-4 view is not 4 bytes off a 16-byte boundary")
    starts = ((ep_id != ep_id.roll(1, 0)).to(torch.int32).argmax(0))
    s2 = (insert_slot - slots + torch.randint(0, slots - 1, (r, streams), generator=g,
                                              device=device)) % slots
    s2[0], s2[1] = starts, (starts - 1) % slots  # clamped stacks, episode ends
    for num_stack in (1, 3):
        got = rbm.gather_batch_aligned_cuda(data, ep_id, s2, False, image_keys, num_stack)
        want = rbm.gather_batch_aligned_plain(data, ep_id, s2, False, image_keys, num_stack)
        torch.cuda.synchronize()
        for part in want:
            for k, w in (want[part].items() if isinstance(want[part], dict) else [(None, want[part])]):
                x = got[part] if k is None else got[part][k]
                if x.shape != w.shape or x.dtype != w.dtype or not torch.equal(x, w):
                    raise AssertionError(f"K4 differs from plain in {part}/{k} (T={num_stack})")
    print(f"K4 copy paths vs plain at {slots} slots x {streams} streams, {r * streams} rows, T = 1 "
          "and 3: wide rows in 16-byte units (64x64x3 frames), 4-byte words (the same 4 bytes off "
          "alignment), bytes (27x27x3 frames); narrow rows in words (fp32) and bytes (27 uint8): "
          "exactly equal")
    return 0.0


def phase_pixel_path(torch, device, card):
    """bench_pixels' configuration end to end, timed as bench.py's
    _bench_fused times it: warm-up chunks of PIXEL_CHUNK iterations until the
    buffer holds the training threshold, then the best of 3 chunks, each
    ending in a device-to-host read of a metric."""
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(device=device,
                                                                         **BENCH_PIXELS)
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(9))
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    warmup = 0
    while True:
        carry, m = run_chunk(carry, PIXEL_CHUNK)
        warmup += PIXEL_CHUNK
        if int(m["buffer_size"][-1]) >= threshold:
            break
    if float(m["critic_loss"][-1]) == 0.0:
        raise AssertionError("the pixel learner did not start at the training threshold")
    before = [p.detach().clone() for p in agent.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    best, chunks = float("inf"), []
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, PIXEL_CHUNK)
        float(m["reward_mean"][-1])  # waits for the chunk, as bench.py's fetch
        best = min(best, time.perf_counter() - t0)
        chunks.append(m)
    launches = read_launches()
    iters = 3 * PIXEL_CHUNK
    per_iter = pixel_launches_per_iter(config.utd_ratio, config.updates_per_iter)
    want = {k: v * iters for k, v in per_iter.items()}
    env_steps_s = PIXEL_CHUNK * config.num_envs / best
    updates_s = PIXEL_CHUNK * config.updates_per_iter * config.utd_ratio / best
    print(f"pixel path (bench_pixels: {json.dumps(BENCH_PIXELS)}, {warmup} warm-up iterations, "
          f"then 3 chunks of {PIXEL_CHUNK}): best chunk {best:.4f} s (host clock ending in a "
          f"sync): {env_steps_s:.1f} env-steps/s, {updates_s:.1f} critic updates/s; launches "
          f"over the {iters} iterations {json.dumps(launches)} [{card}]")
    if launches != want:
        raise AssertionError(f"expected launches {want} on the pixel path, got {launches}")
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(10), num_episodes=16,
                  pixel_keys=rb.image_keys)
    metrics = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    learner = {k: metrics[k] for k in ("critic_loss", "actor_loss", "temperature", "entropy")}
    params = list(agent.parameters())
    buf = carry.rb_state
    frames = [buf.data["observations"][k][: buf.size] for k in rb.image_keys]
    checks = {
        "losses finite": all(bool(torch.isfinite(v).all()) for v in learner.values()),
        "losses non-zero": all(bool((v != 0).all()) for v in learner.values()),
        "temperature > 0": bool((learner["temperature"] > 0).all()),
        "params finite": all(bool(torch.isfinite(p).all()) for p in params),
        "targets finite": all(bool(torch.isfinite(p).all())
                              for p in agent.state.target_params["critic"]),
        "params moved, the encoders' included": all(not torch.equal(p, q)
                                                    for p, q in zip(params, before)),
        "frames rendered": all(f.dtype == torch.uint8 and float(f[:, :2].float().std()) > 1
                               for f in frames),
        "eval finite": all(math.isfinite(v) and 0 <= v <= 100 for v in ev.values()),
    }
    print(f"pixel path outputs: critic_loss {float(learner['critic_loss'][-1]):.5g}, actor_loss "
          f"{float(learner['actor_loss'][-1]):.5g}, temperature "
          f"{float(learner['temperature'][-1]):.5g}, entropy {float(learner['entropy'][-1]):.5g} "
          f"(last iteration); optimizer steps {agent.state.step}; buffer {buf.size} slots; eval "
          f"(16 episodes) {json.dumps(ev)}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"pixel path output checks failed: {bad}")
    return launches, dict(env_steps_s=env_steps_s, updates_s=updates_s, best_chunk_s=best), \
        env, agent, rb, config, carry, run_chunk


def phase_pixel_times(torch, device, card, k2, builds, env, agent, rb, config, carry, run_chunk):
    """K2 (both -fmad builds), K3 and K4's pixel gather at the pixel path's
    shapes, and where a pixel iteration's time goes."""
    from serl_tpu_torch.data import replay_buffer as rbm
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.vision import augmentations as aug

    g = torch.Generator(device=device).manual_seed(11)
    rows = {}
    # K2 on the loop's own states (16 envs, both cameras, 128 px), both builds
    s = carry.env_states.physics
    n, pixels = s.qpos.shape[0], PIXEL_SIZE * PIXEL_SIZE
    render = lambda: rendering.render_cameras_cuda(s, PIXEL_SIZE)
    ops = k2.render_ops(s, PIXEL_SIZE)
    own = ops["scene"] + ops["camera"] + ops["pixel"]
    nbytes = (n * (7 + 1 + 3 + 4) * 4 + rendering.kernel_constants().nbytes
              + 2 * 2 * pixels * 4 + 2 * n * pixels * 3)
    bound_ms, bound_by = bound(nbytes, own)
    fmad = {label: [] for label in builds}
    for label in list(builds) + list(builds)[::-1]:  # shipped, other, other, shipped
        fmad[label].append(profiled_kernel_ms(
            lambda: rendering.render_cameras_cuda(s, PIXEL_SIZE, lib=builds[label]), 50,
            K2_KERNELS))
    rows["render"] = dict(
        ms=per_call_ms(render, calls=50), profiler_ms=profiled_kernel_ms(render, 50, K2_KERNELS),
        profiler_ms_by_kernel={k: profiled_kernel_ms(render, 50, k) for k in K2_KERNELS},
        plain_ms=per_call_ms(lambda: rendering.render_cameras_plain(s, PIXEL_SIZE), calls=5),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=own, library_ms=None,
        ops_per_pixel=ops["pixel"] / (2 * n * pixels), ops_per_env_camera=ops["camera"] / (2 * n),
        ops_per_env=ops["scene"] / n, ops_unhoisted=ops["unhoisted"],
        bound_ms_unhoisted=bound(nbytes, ops["unhoisted"])[0], fmad=fmad)
    print(f"K2 operations (counted in the kernel's code by tests/k2_host.cpp): "
          f"{rows['render']['ops_per_pixel']:.2f} per pixel, "
          f"{rows['render']['ops_per_env_camera']:.1f} per (env, camera), "
          f"{rows['render']['ops_per_env']:.1f} per env, {own} in all; the unhoisted count "
          f"{ops['unhoisted'] / (2 * n * pixels):.2f} per pixel, bound "
          f"{rows['render']['bound_ms_unhoisted']:.6f} ms; device ms of the two builds "
          f"(torch.profiler, 50 calls each, in turns) {json.dumps(fmad)}; the shipped build's "
          f"by kernel {json.dumps(rows['render']['profiler_ms_by_kernel'])} [{card}]")

    # K3 at the main path's call: obs and next_obs of both cameras, 1024 x T = 1
    buf = carry.rb_state
    batch_rows = config.batch_size * config.utd_ratio
    batch = rb.sample(buf, batch_rows, generator=g)
    parts = ("observations", "next_observations")
    imgs = [batch[p][k] for p in parts for k in rb.image_keys]
    offs = [aug.crop_offsets(batch_rows, 4, g, device) for _ in imgs]
    crop = lambda: aug.crop_images(imgs, offs, padding=4, num_batch_dims=2)
    nbytes = 2 * sum(i.numel() for i in imgs) + sum(o.numel() * 8 for o in offs)
    bound_ms, bound_by = bound(nbytes, 0)
    rows["random_crop"] = dict(
        ms=per_call_ms(crop, calls=50), profiler_ms=profiled_kernel_ms(crop, 50, "random_crop_kernel"),
        plain_ms=per_call_ms(lambda: [aug.batched_random_crop_gather(i, o, padding=4,
                                                                     num_batch_dims=2)
                                      for i, o in zip(imgs, offs)], calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None)

    # K4's pixel gather at the main path's sample: 1024 rows, T = 1, on the loop's ring
    slots, streams = buf.ep_id.shape
    s2 = (buf.insert_slot - buf.size
          + torch.randint(0, buf.size - 1, (batch_rows // streams, streams), generator=g,
                          device=device)) % slots
    gather = lambda: rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, s2, False, rb.image_keys,
                                                   rb.num_stack)
    out = gather()
    row_bytes = sum(v.numel() * v.element_size() for v in
                    [out[k] for k in out if not isinstance(out[k], dict)]
                    + list(out["observations"].values()) + list(out["next_observations"].values()))
    nbytes = 2 * row_bytes + s2.numel() * 8
    bound_ms, bound_by = bound(nbytes, 0)
    rows["replay_gather_pixel"] = dict(
        ms=per_call_ms(gather, calls=50),
        profiler_ms=profiled_kernel_ms(gather, 50, "replay_gather_kernel"),
        plain_ms=per_call_ms(lambda: rbm.gather_batch_aligned_plain(
            buf.data, buf.ep_id, s2, False, rb.image_keys, rb.num_stack), calls=10),
        bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=None)
    # the same gather from a cold L2: before each call a 256 MB read evicts
    # the 50 MB L2, and each call takes other rows, as the loop's samples do
    flush = torch.zeros(2**26, device=device)
    fresh = [(buf.insert_slot - buf.size
              + torch.randint(0, buf.size - 1, s2.shape, generator=g, device=device)) % slots
             for _ in range(5)]
    calls = [0]

    def cold_gather():
        flush.sum()
        calls[0] += 1
        rbm.gather_batch_aligned_cuda(buf.data, buf.ep_id, fresh[calls[0] % len(fresh)], False,
                                      rb.image_keys, rb.num_stack)

    cold_ms = profiled_kernel_ms(cold_gather, 50, "replay_gather_kernel")
    rows["replay_gather_pixel"]["profiler_ms_cold_l2"] = cold_ms
    del flush
    for name, row in rows.items():
        cold = (f"; from a cold L2, other rows each call, {cold_ms:.4f} ms"
                if name == "replay_gather_pixel" else "")
        print(f"{name} time: kernel {row['ms']:.4f} ms per call (50 back to back, CUDA events; "
              f"torch.profiler kernel time {row['profiler_ms']:.4f} ms{cold}), plain "
              f"{row['plain_ms']:.4f} ms, library null (no single PyTorch call computes it), "
              f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} ({row['bytes']} bytes"
              + (f", {row['ops']} fp32 ops counted in the kernel's code by tests/k2_host.cpp"
                 if "ops" in row else "") + f") [{card}]")

    # where a pixel iteration's time goes: single calls between CUDA events
    mini = rbm._map(lambda v: v[: config.batch_size], batch)
    obs = carry.obs
    states = carry.env_states
    from serl_tpu_torch.envs.wrappers import add_stack_axis

    act = agent.sample_actions(add_stack_axis(obs, rb.image_keys), generator=g)

    def encode():
        with torch.no_grad():
            return agent.encoder(mini["observations"])

    parts = {
        "render (K2, both cameras)": render,
        "env step_auto_reset (K1 + K2 + obs, reward, reset)": lambda: env.step_auto_reset(
            states, act, generator=g, final_obs=False),
        "policy sample_actions (encoder + policy)": lambda: agent.sample_actions(
            add_stack_axis(obs, rb.image_keys), generator=g),
        "sample (K4, 1024 rows)": lambda: rb.sample(buf, batch_rows, generator=g),
        "crop (K3, one update's 4 image batches)": crop,
        "encoder forward (256-row minibatch, no grad)": encode,
        "critic update (1 of utd_ratio, minibatch 256)": lambda: agent.update(
            mini, networks_to_update=frozenset({"critic"}), generator=g),
        "actor+temperature update (batch 1024)": lambda: agent.update(
            batch, networks_to_update=frozenset({"actor", "temperature"}), generator=g),
        "update_high_utd (crop + 4 critic + 1 actor)": lambda: agent.update_high_utd(
            batch, utd_ratio=config.utd_ratio, generator=g),
    }
    split = {k: per_call_ms(fn, calls=1, repeats=10) for k, fn in parts.items()}
    box = [carry]

    def run(iters):
        box[0], _ = run_chunk(box[0], iters)

    split["whole loop iteration"] = per_call_ms(lambda: run(1), calls=1, repeats=10)
    print("pixel iteration, ms per call (median of 10 single calls between CUDA events, host "
          "launch time included): " + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f" [{card}]")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        agent.update_high_utd(rb.sample(buf, batch_rows, generator=g), utd_ratio=config.utd_ratio,
                              generator=g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("pixel sample + update_high_utd (crop included) ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync in the learner step")
    print_busy_share(torch, "pixel loop", run, card, ("K1", "K2", "K3", "K4", "K5"))
    return rows


def kernel_table(rows, lrows, prows, k5rows, errs, launches_by_path, per_iter, ptxas):
    """The kernel table's entries. `launches` is each kernel's count over the
    timed iterations of the path its row describes: the state learner path
    for K1, K4's state row and K5 (as in earlier runs), the pixel path for
    K2, K3 and K4's pixel row; every path's count stands beside it."""

    def launches(name, path):
        return {"launches": launches_by_path[path][name],
                "launches_by_path": {p: c[name] for p, c in launches_by_path.items()},
                "launches_per_iteration": {p: per_iter[p][name] for p in per_iter}}

    main = rows[MAIN_ENVS]
    kernels = [{
        "name": "control_step",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/control_step.cu",
        "replaces": "serl_tpu/envs/physics/engine.py:348",
        **launches("control_step", "learner"),
        "max_abs_err": errs["K1"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "profiler_ms": main["profiler_ms"],
        "ms_by_envs": {str(n): rows[n]["ms"] for n in BOUND_N},
        "profiler_ms_by_envs": {str(n): rows[n]["profiler_ms"] for n in BOUND_N},
        "plain_ms_by_envs": {str(n): rows[n]["plain_ms"] for n in BOUND_N},
        "bound_ms_by_envs": {str(n): rows[n]["bound_ms"] for n in BOUND_N},
        "ops_per_env": main["ops"] // MAIN_ENVS,
        "critical_path_ops_per_env": main["critical_path_ops"],
        "ptxas": ptxas["control_step"],
    }]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "profiler_ms")
    kernels.append({
        "name": "render",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/render.cu",
        "replaces": "serl_tpu/envs/rendering.py:329",
        **launches("render", "pixel"),
        "max_abs_err": errs["K2"][0],  # uint8 levels, under the pixel rule of tests/torch_k2.py
        **{k: prows["render"][k] for k in timed},
        "shape": [BENCH_PIXELS["num_envs"], 2, PIXEL_SIZE, PIXEL_SIZE, 3],
        "scene_max_abs_err": errs["K2"][1],
        "pixel_rule_by_build": errs["K2"][2],
        **{k: prows["render"][k] for k in ("ops", "ops_per_pixel", "ops_per_env_camera",
                                           "ops_per_env", "ops_unhoisted",
                                           "bound_ms_unhoisted", "fmad")},
        "ptxas": ptxas["render"],
    })
    kernels.append({
        "name": "random_crop",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/random_crop.cu",
        "replaces": "serl_tpu/vision/augmentations.py:34",
        **launches("random_crop", "pixel"),
        "max_abs_err": errs["K3"],
        **{k: prows["random_crop"][k] for k in timed},
        "shape": [4, 1024, 1, PIXEL_SIZE, PIXEL_SIZE, 3],
    })
    kernels.append({
        "name": "replay_gather",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/replay_gather.cu",
        "replaces": "serl_tpu/data/replay_buffer.py:317",
        **launches("replay_gather", "learner"),
        "max_abs_err": errs["K4"],
        **{k: lrows["replay_gather"][k] for k in timed},
        "shape": "2048 rows x 6 fp32 fields (state path)",
    })
    kernels.append({
        "name": "replay_gather_pixel",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/replay_gather.cu",
        "replaces": "serl_tpu/data/replay_buffer.py:317",
        **launches("replay_gather", "pixel"),
        "max_abs_err": errs["K4 pixel"],
        **{k: prows["replay_gather_pixel"][k] for k in timed},
        "profiler_ms_cold_l2": prows["replay_gather_pixel"]["profiler_ms_cold_l2"],
        "shape": "1024 rows of state, two 128 px uint8 frames (T = 1) for obs and next_obs, "
                 "actions, rewards, masks, dones (pixel path)",
    })
    for direction, err in (("fwd", errs["K5"]["y_end_to_end"]), ("bwd", errs["K5"]["dh"])):
        name = f"dense_layer_norm_tanh_{direction}"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "serl_tpu_torch/csrc/dense_layer_norm_tanh.cu",
            "replaces": "serl_tpu/networks/mlp.py:95",
            **launches(name, "learner"),
            "max_abs_err": err,  # y abs; dh relative to its largest |dh| (tests/torch_k5.py)
            **{k: k5rows[(direction, K5_MAIN)][k] for k in timed},
            "shape": k5_label(K5_MAIN),
            "errors": errs["K5"],
            "by_shape": {k5_label(shape): k5rows[(direction, shape)] for shape in K5_SHAPES},
        })
    return kernels


def main(kernels_only: bool = False) -> int:
    """The whole run; with `kernels_only` (--kernels) phases 1 and 2 and K5's
    times only, and no result lines."""
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    for part in ("serl_tpu_torch", os.path.join("tests", "torch_k1.py"),
                 os.path.join("tests", "torch_k2.py"), os.path.join("tests", "torch_k5.py")):
        if not os.path.exists(os.path.join(HERE, part)):
            return fail(f"{part} is not beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # phase 1: device and builds (one nvcc per kernel source, all started
    # together, in a thread, while g++ builds the op-counting host code here)
    card = card_line()
    print(f"card: {card}")
    from serl_tpu_torch.data import replay_buffer as rbm
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.native import build
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    checks = load_checks("torch_k1")
    k2 = load_checks("torch_k2")
    k5_checks = load_checks("torch_k5")
    t0 = time.perf_counter()
    built = {}

    def nvcc():
        try:
            build.build_all(build.KERNEL_SOURCES, [("render", K2_BUILDS[1][1])])
            built["s"] = time.perf_counter() - t0
        except Exception as exc:  # re-raised below, after the join
            built["error"] = exc

    thread = threading.Thread(target=nvcc)
    thread.start()
    s1 = checks.reset_states(1, torch.Generator().manual_seed(0), "cpu")
    checks.op_counts(s1)
    k2.render_ops(s1, 8)
    host_s = time.perf_counter() - t0
    thread.join()
    if "error" in built:
        raise built["error"]
    engine._kernel_library()
    k2_libs = {label: rendering._render_library() if extra is None
               else rendering.bind_library(build.load_library("render", extra))
               for label, extra in K2_BUILDS}
    augmentations._crop_library()
    rbm._gather_library()
    k5._library()
    t1 = time.perf_counter()
    ptxas = {}
    for name, extra in [(name, None) for name in build.KERNEL_SOURCES] + [("render", K2_BUILDS[1][1])]:
        with open(build.ptxas_path(name, extra)) as f:
            ptxas[name if extra is None else f"{name} {' '.join(extra)}"] = " | ".join(
                line.strip() for line in f if "registers" in line or "spill" in line)
    print(f"K1-K5 built with nvcc ({', '.join(build.KERNEL_SOURCES)}, and render.cu with "
          f"{K2_BUILDS[1][0]} beside the shipped {K2_BUILDS[0][0]}, in parallel) in "
          f"{built['s']:.2f} s, all loaded after {t1 - t0:.2f} s; ptxas {json.dumps(ptxas)}; "
          f"K1's and K2's op-counting host builds (g++) meanwhile, done after {host_s:.2f} s")

    # phase 2: every kernel against its plain version
    errs = {"K1": phase_kernel_vs_plain(torch, engine, checks, device),
            "K2": phase_k2_vs_plain(torch, checks, k2, k2_libs, device),
            "K3": phase_k3_vs_plain(torch, device),
            "K4": phase_k4_vs_plain(torch, device),
            "K4 pixel": max(phase_k4_pixel_vs_plain(torch, device),
                            phase_k4_copy_paths_vs_plain(torch, device)),
            "K5": phase_k5_vs_plain(torch, k5_checks, device)}
    if kernels_only:
        phase_k5_times(torch, k5_checks, device, card)
        print(f"--kernels: every kernel built and held against its plain version; "
              f"{time.perf_counter() - t0:.1f} s from the first build")
        return 0

    # phase 3: the actor path, the state learner path, the pixel path
    actor_launches, env, agent, carry, run_chunk = phase_actor_path(torch, device)
    learner_launches, rates, l_env, l_agent, l_rb, l_config, l_carry, l_run = \
        phase_learner_path(torch, device, card)
    pixel_launches, p_rates, p_env, p_agent, p_rb, p_config, p_carry, p_run = \
        phase_pixel_path(torch, device, card)

    # phase 4: times
    rows = phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk)
    lrows = phase_learner_times(torch, device, card, l_agent, l_rb, l_config, l_carry, l_run)
    prows = phase_pixel_times(torch, device, card, k2, k2_libs, p_env, p_agent, p_rb, p_config,
                              p_carry, p_run)
    k5rows = phase_k5_times(torch, k5_checks, device, card)

    per_iter = {"actor": ACTOR_LAUNCHES,  # the whole actor path, not per iteration
                "learner": learner_launches_per_iter(l_config.utd_ratio,
                                                     l_config.updates_per_iter),
                "pixel": pixel_launches_per_iter(p_config.utd_ratio, p_config.updates_per_iter)}
    kernels = kernel_table(rows, lrows, prows, k5rows, errs,
                           {"actor": actor_launches, "learner": learner_launches,
                            "pixel": pixel_launches}, per_iter, ptxas)
    print(f"learner rates: {rates['env_steps_s']:.1f} env-steps/s, {rates['updates_s']:.1f} "
          f"critic updates/s [{card}]")
    print(f"pixel rates: {p_rates['env_steps_s']:.1f} env-steps/s, {p_rates['updates_s']:.1f} "
          f"critic updates/s [{card}]")
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax", "serl_tpu."))
           or m == "serl_tpu"]
    if bad:
        return fail(f"the port pulled in JAX or serl_tpu modules: {bad[:5]}")
    print(f"total {time.perf_counter() - t0:.1f} s from the first build")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(kernels_only=sys.argv[1:] == ["--kernels"])
    except Exception as exc:  # every phase failure ends the run with no result line
        import traceback

        traceback.print_exc()
        code = fail(f"{type(exc).__name__}: {exc}")
    sys.exit(code)
