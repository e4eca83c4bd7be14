#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (serl_tpu_torch) runs on one GPU.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. device: the card's name and power limit; build the control-step kernel
     (K1, serl_tpu_torch/csrc/control_step.cu) with nvcc from the sources in
     this checkout, and the host build of its code that counts its operations
     (tests/k1_host.cpp, g++), and print the build times;
  2. K1 against control_step_plain at N = 128 and 2048 env states from two
     sources (a plain-version rollout with random actions, and constructed
     grasp states with the cube between the pads), which must include active
     floor and pad contacts: one control step, field by field and env by env,
     and a 100-step kernel-vs-plain rollout, under the tolerance rule of
     tests/torch_k1.py (a tight per-env tolerance that at most N // 100 envs
     may exceed, and a cap that none may);
  3. the main path: make_state_sim_experiment with 128 envs and the
     full-width networks, 20 loop iterations (8 random, 12 policy) and a
     128-episode evaluate, with K1's launch count read around it;
  4. times on the card: K1 and the plain version at N = 128 and 2048 (calls
     back to back between one pair of CUDA events, and K1's kernel time from
     torch.profiler), K1's bound from its counted operations, where an actor
     step's time goes, and the loop's device busy share (torch.profiler).
It prints the kernel table as one JSON line, then the card's name and power
limit, and last {"ok": true, "device": {...}}. It needs one CUDA card and the
repository around it (serl_tpu_torch/ and tests/torch_k1.py); it never
imports JAX or serl_tpu.
"""

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
BOUND_N = (128, 2048)
MAIN_ENVS = 128


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_checks():
    """tests/torch_k1.py, loaded by its path (a package named `tests` that is
    installed elsewhere must not shadow it)."""
    spec = importlib.util.spec_from_file_location(
        "torch_k1", os.path.join(HERE, "tests", "torch_k1.py"))
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


def profiled_kernel_ms(fn, calls: int, kernel: str):
    """Device time per launch of `kernel` in a torch.profiler trace of
    `calls` calls of fn, or None when the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    total_us = sum(e.self_device_time_total for e in events)
    count = sum(e.count for e in events)
    return total_us / 1e3 / count if count else None


# ---------------------------------------------------------------- phases


def phase_kernel_vs_plain(torch, engine, checks, device):
    g = torch.Generator(device=device).manual_seed(0)
    main_path_err = 0.0
    for n in BOUND_N:
        for source, make in (("rollout", checks.rollout_states), ("grasp", checks.grasp_states)):
            s = make(n, g, device)
            floor, pad = engine.active_contacts(s)
            n_floor, n_pad = int(floor.sum()), int(pad.sum())
            failures, summary, _ = checks.compare_step(engine.control_step_cuda, s)
            print(f"K1 vs plain, N={n}, {source} states: active floor corners {n_floor}, "
                  f"active pad points {n_pad}; max abs err {fmt(summary['max_err'])}; envs "
                  f"beyond the tight tolerance {summary['envs_over_atol']} (at most "
                  f"{summary['budget']})")
            if failures:
                raise AssertionError(f"N={n} {source}: " + "; ".join(failures))
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


def phase_main_path(torch, engine, device):
    from serl_tpu_torch.envs.panda_pick import STATE_OBS_DIM
    from serl_tpu_torch.training.launcher import make_state_sim_experiment
    from serl_tpu_torch.training.loop import evaluate

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=0, device="cuda", num_envs=MAIN_ENVS, buffer_capacity=100_000,
        random_steps=1000, training_starts=10**9,
    )
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    engine.control_step.launches = 0
    t0 = time.perf_counter()
    carry, metrics = run_chunk(carry, 20)
    torch.cuda.synchronize()
    actor_s = time.perf_counter() - t0
    ev = evaluate(env, agent, torch.Generator(device=device).manual_seed(2), num_episodes=128)
    torch.cuda.synchronize()
    launches = engine.control_step.launches

    print(f"main path: 20 loop iterations (8 random, 12 policy) x {MAIN_ENVS} envs + "
          f"evaluate(num_episodes=128): K1 launches {launches}; actor "
          f"{20 * MAIN_ENVS / actor_s:.1f} env-steps/s (host clock, {actor_s:.3f} s); "
          f"eval {json.dumps(ev)}")
    if launches != 120:
        raise AssertionError(f"expected 120 K1 launches on the main path, got {launches}")
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
        raise AssertionError(f"main path output checks failed: {bad}")
    return launches, env, agent, carry, run_chunk


def phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk):
    g = torch.Generator(device=device).manual_seed(3)
    rows = {}
    for n in BOUND_N:
        s = checks.rollout_states(n, g, device, steps=5)
        step = lambda: engine.control_step_cuda(s)
        ms = per_call_ms(step, calls=50)
        prof_ms = profiled_kernel_ms(step, calls=50, kernel="control_step_kernel")
        plain_ms = per_call_ms(lambda: engine.control_step_plain(s), calls=2, repeats=3)
        ops_per_env = checks.op_counts(s)
        ops = int(ops_per_env.sum())
        bytes_moved = 2 * sum(x.numel() * 4 for x in s) + engine.kernel_constants().nbytes
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
        rows[n] = dict(ms=ms, profiler_ms=prof_ms, plain_ms=plain_ms, ops=ops,
                       bytes=bytes_moved, bound_ms=max(t_bytes, t_ops),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
        prof_text = "not measured" if prof_ms is None else f"{prof_ms:.4f} ms"
        print(f"K1 time, N={n}: kernel {ms:.4f} ms per launch (50 back to back, CUDA events; "
              f"torch.profiler kernel time {prof_text}), plain {plain_ms:.3f} ms per control "
              f"step; bound {rows[n]['bound_ms']:.6f} ms by {rows[n]['bound_by']} ({ops} fp32 ops "
              f"= {ops_per_env.min()}-{ops_per_env.max()} per env, counted in the kernel's code "
              f"by tests/k1_host.cpp; {bytes_moved} bytes); no single PyTorch call computes K1, "
              f"so library_ms is null [{card}]")

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

    def one_iter():
        box[0], _ = run_chunk(box[0], 1)

    split["whole loop iteration"] = per_call_ms(one_iter, calls=1, repeats=10)
    print(f"actor step at N={MAIN_ENVS}, ms per call (median of 20 single calls between CUDA "
          "events, host launch time included): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}) + f" [{card}]")

    # device busy share of the loop: kernel time from a torch.profiler trace
    # over the same number of iterations that a host clock times unprofiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    box[0], _ = run_chunk(box[0], iters)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        box[0], _ = run_chunk(box[0], iters)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels if "control_step_kernel" in e.key) / 1e3
    if busy_ms > 0:
        print(f"actor loop, {iters} iterations at N={MAIN_ENVS}: wall {wall_ms:.2f} ms "
              f"(host clock, unprofiled), device busy {busy_ms:.3f} ms (torch.profiler), "
              f"busy share {busy_ms / wall_ms:.4f}, idle share {1 - busy_ms / wall_ms:.4f}; "
              f"K1 {k1_ms:.3f} ms = {k1_ms / busy_ms:.4f} of device time [{card}]")
    else:
        print("actor loop device busy share: not measured (the profiler recorded no "
              "device time)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    for part in ("serl_tpu_torch", os.path.join("tests", "torch_k1.py")):
        if not os.path.exists(os.path.join(HERE, part)):
            return fail(f"{part} is not beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # phase 1: device and builds
    card = card_line()
    print(f"card: {card}")
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.native import build

    checks = load_checks()
    t0 = time.perf_counter()
    engine._kernel_library()
    t1 = time.perf_counter()
    checks.op_counts(checks.reset_states(1, torch.Generator().manual_seed(0), "cpu"))
    t2 = time.perf_counter()
    with open(os.path.join(build.BUILD_DIR, "control_step.ptxas.txt")) as f:
        ptxas = " | ".join(line.strip() for line in f if "registers" in line or "spill" in line)
    print(f"K1 built with nvcc and loaded in {t1 - t0:.2f} s; ptxas: {ptxas}; its op-counting "
          f"host build (g++) in {t2 - t1:.2f} s")

    # phase 2: K1 against its plain version
    max_abs_err = phase_kernel_vs_plain(torch, engine, checks, device)

    # phase 3: the main path, through K1
    launches, env, agent, carry, run_chunk = phase_main_path(torch, engine, device)

    # phase 4: times
    rows = phase_times(torch, engine, checks, device, card, env, agent, carry, run_chunk)

    main = rows[MAIN_ENVS]
    kernels = [{
        "name": "control_step",
        "route": "cuda",
        "source": "serl_tpu_torch/csrc/control_step.cu",
        "replaces": "serl_tpu/envs/physics/engine.py:348",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "ms_by_envs": {str(n): rows[n]["ms"] for n in BOUND_N},
        "profiler_ms_by_envs": {str(n): rows[n]["profiler_ms"] for n in BOUND_N},
        "plain_ms_by_envs": {str(n): rows[n]["plain_ms"] for n in BOUND_N},
        "bound_ms_by_envs": {str(n): rows[n]["bound_ms"] for n in BOUND_N},
    }]
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax", "serl_tpu."))
           or m == "serl_tpu"]
    if bad:
        return fail(f"the port pulled in JAX or serl_tpu modules: {bad[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:  # every phase failure ends the run with no result line
        import traceback

        traceback.print_exc()
        code = fail(f"{type(exc).__name__}: {exc}")
    sys.exit(code)
