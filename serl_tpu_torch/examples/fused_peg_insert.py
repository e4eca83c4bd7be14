"""Peg insertion (sparse reward) with RLPD demos and expert interventions.

Port of `examples/fused_peg_insert.py`, with its flags and defaults: the
PEG_INSERT_CONFIG pose task (`envs/tasks.py`), 20 demo streams of the
scripted pose expert with auto-reset (every demo row a real approach step)
mixed 50/50 into every batch, the expert owning whole episodes with
probability 0.5 annealed to 0 over 100k env steps, discount 0.97, 16 envs,
batch 256 x UTD 4, 10 critics subsampled to 2.

  * state (default): the 13-dim flat state, a 100,000-row buffer, one
    chunk per evaluation period;
  * --pixels: DrQ from the front and wrist cameras and the 10-dim proprio,
    the memory-efficient uint8 ring of 20,000 rows, chunks of 10.

An evaluation (32 argmax episodes) runs every --eval_period env steps; the
run stops once two in a row reach --success_stop (the JAX example's fixed
0.9). Lines go to --log (default stdout), and each evaluation's numbers to
--log_dir as a JSON line.

    python -m serl_tpu_torch.examples.fused_peg_insert --total_steps 100000
    python -m serl_tpu_torch.examples.fused_peg_insert --pixels --total_steps 150000

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import functools
import sys
import time

import torch

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.demos import collect_episodes, demos_to_buffer
from serl_tpu_torch.envs.scripted_expert import pose_expert_action
from serl_tpu_torch.envs.tasks import (
    PEG_INSERT_CONFIG,
    PIXEL_STATE_DIM,
    STATE_OBS_DIM,
    PandaPoseTaskEnv,
)
from serl_tpu_torch.training.launcher import (
    make_drq_agent,
    make_pixel_replay_buffer,
    make_sac_agent,
    make_state_replay_buffer,
)
from serl_tpu_torch.training.loop import LoopConfig, evaluate, make_fused_loop

ACT_DIM = 7
IMAGE_KEYS = ("front", "wrist")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pixels", action="store_true",
                   help="DrQ from the front and wrist cameras (the reference's E3 class)")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--encoder_type", default="small",
                   help="small | resnet | resnet50 | resnet-pretrained")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    p.add_argument("--training_starts", type=int, default=1000)
    p.add_argument("--random_steps", type=int, default=1000)
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--intervention_prob", type=float, default=0.5)
    p.add_argument("--intervention_mode", default="episode",
                   choices=["step", "episode", "rescue"])
    p.add_argument("--intervention_decay_steps", type=int, default=100_000)
    p.add_argument("--discount", type=float, default=0.97)
    p.add_argument("--total_steps", type=int, default=200_000)
    p.add_argument("--eval_period", type=int, default=4000)
    p.add_argument("--success_stop", type=float, default=0.9)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def pose_expert(config):
    """The scripted pose expert for a task config: states -> (N, 7) actions."""
    return functools.partial(pose_expert_action, target_pose=config.target_pose,
                             action_scale=config.action_scale)


def expert_demos(env, expert, seed: int, num_demos: int, pixels: bool = False):
    """num_demos auto-reset streams of the expert (no noise) from a generator
    seeded with seed + 1000, as a write-once demo ring on the env's device
    (pixel demos without next_observations: the ring rebuilds them).
    Returns (demo ring state, the successful episodes, all episodes the
    streams completed; success ends an episode, so every success step is
    one)."""
    episode_len = env.time_limit_steps
    g = torch.Generator(device=env.device).manual_seed(seed + 1000)
    trans = collect_episodes(env, lambda states, _: expert(states), g, num_episodes=num_demos,
                             episode_len=episode_len, pixel_obs=pixels, auto_reset=True)
    successes = int(trans.pop("success").sum())
    episodes = int(trans["dones"].sum())
    capacity = num_demos * episode_len
    if pixels:
        trans.pop("next_observations")
        demo_rb = make_pixel_replay_buffer(capacity=capacity, image_keys=IMAGE_KEYS,
                                           image_size=env.render_size, state_dim=PIXEL_STATE_DIM,
                                           action_dim=ACT_DIM, device=env.device)
    else:
        demo_rb = make_state_replay_buffer(capacity, obs_dim=STATE_OBS_DIM, action_dim=ACT_DIM,
                                           device=env.device)
    return demos_to_buffer(demo_rb, trans, episode_len), successes, episodes


def demo_line(num_demos: int, episode_len: int, successes: int, episodes: int) -> str:
    return (f"loaded {num_demos * episode_len} demo transitions ({episodes} episodes, "
            f"success-step frac {successes / (num_demos * episode_len):.2f})")


def build(args):
    """(env, agent, rb, config, init_fn, run_chunk, demo_state, info): info
    holds the lines to print and the demos' successful and all episodes."""
    cfg = PEG_INSERT_CONFIG
    env = PandaPoseTaskEnv(config=cfg, image_obs=args.pixels, render_size=args.image_size,
                           device=args.device)
    expert = pose_expert(cfg)
    demo_state, info = None, {"lines": []}
    if args.num_demos > 0:
        demo_state, successes, episodes = expert_demos(env, expert, args.seed, args.num_demos,
                                                       args.pixels)
        info = {"lines": [demo_line(args.num_demos, cfg.time_limit_steps, successes, episodes)],
                "demo_successes": successes, "demo_episodes": episodes}
    # pixel rows hold two 128 px frames: a 20k-row ring; states keep 100k
    capacity = 20_000 if args.pixels else 100_000
    config = LoopConfig(
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=1,
        training_starts=args.training_starts,
        random_steps=args.random_steps,
        buffer_capacity=(capacity // args.num_envs) * args.num_envs,
        demo_fraction=0.5 if demo_state is not None else 0.0,
        intervention_prob=args.intervention_prob,
        intervention_mode=args.intervention_mode,
        intervention_decay_steps=args.intervention_decay_steps,
    )
    if args.pixels:
        rb = make_pixel_replay_buffer(capacity=config.buffer_capacity, image_keys=IMAGE_KEYS,
                                      image_size=args.image_size, state_dim=PIXEL_STATE_DIM,
                                      action_dim=ACT_DIM, device=env.device)
        size = args.image_size
        sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
                  **{k: torch.zeros((1, 1, size, size, 3), dtype=torch.uint8)
                     for k in rb.image_keys}}
        agent = make_drq_agent(args.seed, sample, torch.zeros((1, ACT_DIM)),
                               image_keys=rb.image_keys, encoder_type=args.encoder_type,
                               discount=args.discount, device=env.device)
    else:
        rb = make_state_replay_buffer(config.buffer_capacity, obs_dim=STATE_OBS_DIM,
                                      action_dim=ACT_DIM, device=env.device)
        agent = make_sac_agent(args.seed, obs_dim=STATE_OBS_DIM, action_dim=ACT_DIM,
                               discount=args.discount, device=env.device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=expert)
    return env, agent, rb, config, init_fn, run_chunk, demo_state, info


def main(argv=None):
    args = parser().parse_args(argv)
    out = open(args.log, "a") if args.log else sys.stdout
    env, agent, rb, config, init_fn, run_chunk, demo_state, info = build(args)
    for line in info["lines"]:
        print(line, file=out, flush=True)
    logger = Logger(description="fused_peg_insert" + ("_pixels" if args.pixels else ""),
                    output_dir=args.log_dir, variant=vars(args))
    carry = init_fn(agent, args.seed, demo_state=demo_state)
    # loop iterations per chunk: 10 with pixels, else an evaluation period's
    chunk = 10 if args.pixels else max(args.eval_period // config.num_envs, 1)
    eval_every = max(args.eval_period // (config.num_envs * chunk), 1)
    t0 = time.time()
    prev_ep, prev_suc, n_chunks, solve_streak = 0, 0.0, 0, 0
    while carry.env_steps < args.total_steps:
        carry, m = run_chunk(carry, chunk)
        n_chunks += 1
        if n_chunks % eval_every:
            continue
        steps = carry.env_steps
        ep, suc = int(m["ep_count"][-1]), float(m["succ_sum"][-1])
        train_succ = (suc - prev_suc) / max(ep - prev_ep, 1)
        prev_ep, prev_suc = ep, suc
        ev = evaluate(env, carry.agent, steps, pixel_keys=rb.image_keys)
        rate = steps / (time.time() - t0)
        print(f"steps {steps} ({rate:.0f}/s) train_succ {train_succ:.2f} "
              f"eval_succ {ev['eval/success_rate']:.2f} eval_ret {ev['eval/return_mean']:.1f}",
              file=out, flush=True)
        logger.log({"env_steps": steps, "env_steps_per_s": rate,
                    "train/success_rate": train_succ, **ev}, step=steps)
        # solved: two evaluations in a row at the bar
        solve_streak = solve_streak + 1 if ev["eval/success_rate"] >= args.success_stop else 0
        if solve_streak >= 2:
            print(f"SOLVED (eval >= {args.success_stop} on 2 consecutive evals) at {steps} "
                  f"env steps ({time.time() - t0:.0f}s)", file=out, flush=True)
            break
    logger.close()
    return carry


if __name__ == "__main__":
    main()
