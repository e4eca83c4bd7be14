"""The DrQ pixel loop's rates at the recipe's shape, row by row.

Port of the JAX package's `tools/perf_pixels.py`, with its rows and defaults.
Each row builds `training/launcher.py::make_drq_sim_experiment` (16 envs, two
128 px cameras, the small encoder, batch 256 x UTD 4) and times the fused
loop: warm-up chunks until the ring holds a batch's rows, then the best of 3
chunks, each ending in a device-to-host read. A loop iteration steps the
envs (K1), renders both cameras (K2), inserts, samples its batches (K4) and
runs `updates_per_iter` update_high_utd calls (K3 and K5):

  * the full loop at the reference ratio (UTD 4 x 2 updates an iteration);
  * the full loop at UTD 4 x 1;
  * the full loop with one encoder shared by both cameras;
  * the actor alone (act, render, insert: training never starts);
  * the full loop at 64 px.

    python -m serl_tpu_torch.tools.perf_pixels [--image_size 128]
    python -m serl_tpu_torch.tools.perf_pixels --device cpu --num_envs 2 --batch_size 4 --utd_ratio 2 --image_size 32 --iters 1

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import time
from typing import List, Optional, Tuple

import torch

from serl_tpu_torch import resolve_device

ROWS = (
    ("full loop, reference ratio (UTD4 x2 upd/iter)",
     dict(updates=True, shared_encoder=False)),
    ("full loop, UTD4 x1 upd/iter (the shape r2's doc measured)",
     dict(updates=True, shared_encoder=False, updates_per_iter=1)),
    ("full loop, SHARED camera encoder (UTD4 x2)",
     dict(updates=True, shared_encoder=True)),
    ("actor-only (act + render + insert)",
     dict(updates=False, shared_encoder=False)),
    ("full loop @64px, reference ratio",
     dict(updates=True, shared_encoder=False, image_size=64)),
)


def bench_loop(iters: int = 25, updates: bool = True, shared_encoder: bool = False,
               image_size: int = 128, num_envs: int = 16, updates_per_iter: int = 2,
               batch_size: int = 256, utd_ratio: int = 4, device=None) -> Tuple[float, float,
                                                                                  float]:
    """(env-steps/s, critic grad-steps/s, ms an iteration) of the fused loop
    in chunks of `iters` iterations; `updates=False` never starts training."""
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment

    device = resolve_device(device)
    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=0,
        encoder_type="small",
        image_size=image_size,
        shared_encoder=shared_encoder,
        num_envs=num_envs,
        batch_size=batch_size,
        utd_ratio=utd_ratio,
        updates_per_iter=updates_per_iter,
        training_starts=0 if updates else 10**9,
        random_steps=0,
        buffer_capacity=num_envs * 640,
        device=device,
    )
    carry = init_fn(agent, torch.Generator(device=device).manual_seed(0))
    threshold = config.batch_size * config.utd_ratio if updates else 0
    while True:
        carry, m = run_chunk(carry, iters)
        if int(m["buffer_size"][-1]) >= threshold:
            break
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        carry, m = run_chunk(carry, iters)
        float(m["reward_mean"][-1])
        best = min(best, time.perf_counter() - t0)
    steps_s = iters * config.num_envs / best
    grads_s = (iters * config.updates_per_iter * config.utd_ratio / best
               if updates else 0.0)
    return steps_s, grads_s, 1000 * best / iters


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> List[Tuple[str, float, float, float]]:
    """Prints a markdown row per configuration: label, env-steps/s, critic
    grad-steps/s, ms an iteration; returns the rows."""
    args = parser().parse_args(argv)
    rows = []
    for label, kw in ROWS:
        kw = dict(kw)
        kw.setdefault("image_size", args.image_size)
        s, g, ms = bench_loop(iters=args.iters, num_envs=args.num_envs,
                              batch_size=args.batch_size, utd_ratio=args.utd_ratio,
                              device=args.device, **kw)
        rows.append((label, s, g, ms))
        print(f"| {label} | {s:,.0f} | {g:,.0f} | {ms:.1f} |", flush=True)
    return rows


if __name__ == "__main__":
    main()
