"""Run one cell of the benchmark of the port (serl_tpu_torch) on the CUDA card it finds.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`, from the process's start): build the nvcc
kernels (once per checkout, into serl_tpu_torch/_build/), build the cell's
loop, write the seed's weights, fill the ring with the loop's random-action
steps, run the checked learning calls (their outputs kept for the check) and
warm up; with the learner off, the random sweeps, the policy's first step
and the warm-up. The window then calls `run_chunk` until `--seconds` have
passed and ends on a device-to-host read; `env_steps_per_s` is every env
step of the window over all its time. With `--trace 1` the window runs under
torch.profiler, with the benchmark's spans around each layer, and the result
carries the per-layer metrics instead. After the window (with the learner
off, once the loop has written the whole ring again and it has been read
back) the program's state is freed and the reference follows the checked
calls (`check.py`).

`--mode control` puts the reference, one step below the configuration's
precision, in the program's place, and `--mode half_batch` a reference that
leaves out half of every minibatch: these give the readings that the limits
are set from (PERF.md), and the benchmark's own runs never use them.

The last line of standard output is the result as one JSON object; the last
lines of standard error are each compared number beside its limit.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import cell as cells  # noqa: E402
from benchmark import check, envcheck, manifest, trace  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "serl_tpu")  # compared with each module's top-level name
MODES = ("program", "control", "half_batch")
NOT_COMPARED_WITHOUT_LEARNER = {"loss_gap": "no learning call", "grad_gap": "no learning call",
                                "change_gap": "no learning call",
                                "draw_z": "the learner draws nothing"}


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _host_counts(device) -> Dict[str, int]:
    """Garbage collections and the caching allocator's cudaMalloc calls and
    retries so far: what can stall the host inside the window."""
    counts = {f"gc{i} collections": g["collections"] for i, g in enumerate(gc.get_stats())}
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        counts.update({"segments allocated": stats.get("segment.all.allocated", 0),
                       "alloc retries": stats.get("num_alloc_retries", 0)})
    return counts


def limits_of(workload: str) -> Dict[str, float]:
    return manifest.load_json(f"{manifest.HERE}/limits/{workload}.json")


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
             mode: str = "program", traffic_overrides: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None, log=print) -> Dict:
    """One run of a cell; returns the result object (without printing it)."""
    entry = manifest.cell(workload)
    config = {**manifest.load_json(f"{manifest.ROOT}/{entry['config_entry']['file']}"),
              **(config_overrides or {})}
    traffic = {**manifest.traffic(entry["traffic"]), **(traffic_overrides or {})}
    learner = cells.learns(traffic)
    if mode == "half_batch" and not learner:
        raise ValueError(f"{workload}'s learner is off: it has no batch to halve")
    phases = {"imports": time.perf_counter() - PROCESS_START}
    if device.type == "cuda":
        from serl_tpu_torch.native.build import KERNEL_SOURCES, build_all
        build_all(KERNEL_SOURCES)  # every nvcc at once, on the first run in a checkout only
    phases["kernels"] = time.perf_counter() - PROCESS_START
    env, agent, rb, _, init_fn, run_chunk = cells.build(config, traffic, seed, device)
    phases["the program's loop and agent"] = time.perf_counter() - PROCESS_START
    initial = cells.make_weights(agent, config, seed, device)
    probe = cells.Probe(agent, env, rb, traffic, device)
    probe.capture()
    carry = cells.set_up(agent, env, rb, init_fn, run_chunk, traffic, seed, probe)
    probe.remove()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START
    phases["weights, ring, checked calls, warm-up"] = setup_s
    log("set-up s at the end of each phase: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))

    before = _host_counts(device)
    prof, spans = None, trace.Spans()
    if traced:
        probe.spans(spans)
    probe.watch_env()  # its copies lie outside the spans
    if traced:
        prof = trace.profiler()
        prof.start()
        with spans(trace.WINDOW):
            carry, iters, elapsed, losses, chunks = cells.window(run_chunk, carry, seconds,
                                                                 traffic["chunk_iters"], learner)
        prof.stop()
    else:
        carry, iters, elapsed, losses, chunks = cells.window(run_chunk, carry, seconds,
                                                             traffic["chunk_iters"], learner)
    probe.remove()
    probe.objs = {}
    after = _host_counts(device)
    log("during the window: " + ", ".join(f"{k} {after[k] - before[k]}" for k in before))
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(losses).all(1)).sum())
    where: Dict = {}
    if not learner:  # the whole ring, written again after the window, read back
        carry, shadow = cells.refill(rb, run_chunk, carry)
        read_back = check.readback(rb, carry.rb_state, shadow, cells.sub_seed(seed, "readback"),
                                   where)
        del shadow
    learner_ran = not learner and agent.state.step > 0  # optimizer steps with the learner off
    del carry, agent, env, rb, init_fn, run_chunk, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program's state is freed
    policy = probe.policy if probe.policy and probe.policy["after_calls"] <= len(probe.calls) else None
    ref = check.follow(config, traffic, initial, probe.calls, policy, device)
    if mode == "program":
        side = (probe.losses, probe.first_moments, probe.params_after,
                None if policy is None else policy["actions"])
    else:
        side = check.follow(config, traffic, initial, probe.calls, policy, device,
                            prec=check.precision(config, control=mode == "control"),
                            fault=None if mode == "control" else mode)
    numbers = check.compare(initial, ref, side, where)
    if learner:
        numbers["ring_rows"] = check.ring_rows(probe.inserts, probe.fill, probe.shapes, probe.calls,
                                               config["image_keys"], device)
        numbers["draw_z"] = check.draw_z(probe.calls, config, traffic, where)
    else:
        numbers["ring_rows"] = read_back
    numbers.update(envcheck.numbers(probe.env_records, config["image_keys"], config["image_size"],
                                    device, control=mode == "control", where=where))
    log(f"env steps checked: {[r['step'] for r in probe.env_records]}")
    for name, what in where.items():
        log(f"{name} set by {what}")
    limits = limits_of(workload)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    missing = sorted(set(limits) - set(numbers))
    if missing or learner_ran:
        log(f"limits with no number: {missing}; the learner ran with the learner off: {learner_ran}")
    correct = (iters > 0 and failed == 0 and not missing and set(numbers) <= set(limits)
               and not learner_ran and all(math.isfinite(v) for v in numbers.values())
               and all(v <= limits[k] for k, v in numbers.items()))

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    metrics: Dict[str, Dict] = {}
    result = {"correct": bool(correct), "attempted": iters, "failed": failed}
    q = statistics.quantiles(chunks, n=20) if len(chunks) > 1 else chunks * 19
    log(f"host s a chunk: min {min(chunks):.4f} p5 {q[0]:.4f} p50 {q[9]:.4f} p95 {q[18]:.4f} "
        f"max {max(chunks):.4f}")
    steps = iters * traffic["updates_per_iter"] * traffic["utd_ratio"] if learner else 0
    log(f"window: {iters} iterations in {elapsed:.4f} s; set-up {setup_s:.4f} s; "
        f"critic gradient steps/s {steps / elapsed:.4f}")
    if traced:
        t = time.perf_counter()
        run = trace.reduce(prof, trace.Run(config=config, traffic=traffic,
                                           calls=manifest.flops(entry["config"]).calls(config, traffic),
                                           iterations=iters, window_ns=(0, 0)), spans.spans)
        log(f"trace: {len(run.ops)} device operations, {run.unlinked} without a launch in the "
            f"trace, read in {time.perf_counter() - t:.1f} s")
        for m in entry["per_layer"]:
            value = manifest.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=run.busy_s(), window_s=run.window_s)
        result["breakdown"] = trace.breakdown(run)
    else:
        rates = {"env_steps_per_s": iters * traffic["num_envs"] / elapsed, "setup_s": setup_s}
        for m in entry["end_to_end"]:
            metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=device_info)
    if not learner:
        result["not_compared"] = NOT_COMPARED_WITHOUT_LEARNER
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--mode", choices=MODES, default="program")
    args = parser.parse_args(argv)

    chips = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), args.mode, log=log)
    log(f"card: {power_limit()}")  # beside mfu, read once the window has closed
    found = banned_modules()
    if found:
        log(f"the run imported {found}: the JAX package or JAX itself; no result")
        return 3
    for name, why in result.get("not_compared", {}).items():
        log(f"check {name} not applicable: {why}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
