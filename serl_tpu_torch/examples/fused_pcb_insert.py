"""PCB component insertion: the peg recipe at PCB tolerances, with pause and
resume.

Port of `examples/fused_pcb_insert.py`, with its flags and defaults: the
PCB_INSERT_CONFIG pose task (thresholds 5/5/3 mm and 0.1 rad, a tighter z
box), the peg recipe from states (20 auto-reset expert demo streams at
50/50, the expert owning whole episodes with probability 0.5 annealed over
100k env steps, discount 0.97, 16 envs, batch 256 x UTD 4), and `run_fused`
(chunks of 50, an evaluation every 5 chunks, solved at two evaluations in a
row >= 0.9, or --success_stop). Options: `--demo_reset_prob` starts episodes from a bank of
expert-visited states (8 streams x 100 steps, rebuilt from the seed: the
bank is not part of a checkpoint), `--bc_weight` adds the Q-filtered BC
term to the actor, `--lr_decay` decays both learning rates by a cosine over
the run.

    python -m serl_tpu_torch.examples.fused_pcb_insert --total_steps 200000 \\
        --checkpoint_dir /tmp/pcb_ckpt
    touch /tmp/pcb_ckpt/PAUSE      # the whole run is saved, and it stops
    python -m serl_tpu_torch.examples.fused_pcb_insert --total_steps 200000 \\
        --checkpoint_dir /tmp/pcb_ckpt --resume

Runs on the CUDA card unless `--device cpu`; each chunk's log goes to
--log_dir (or the temp dir's serl_tpu_logs/) as a JSON line.
"""

import argparse

import torch

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.demos import collect_state_bank
from serl_tpu_torch.envs.tasks import PCB_INSERT_CONFIG, STATE_OBS_DIM, PandaPoseTaskEnv
from serl_tpu_torch.examples.fused_peg_insert import (
    ACT_DIM,
    demo_line,
    expert_demos,
    pose_expert,
)
from serl_tpu_torch.training.launcher import make_sac_agent, make_state_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop
from serl_tpu_torch.training.runner import run_fused

CHUNK_ITERS, EVAL_PERIOD_CHUNKS, SUCCESS_STOP = 50, 5, 0.9


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
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
    p.add_argument("--intervention_min_prob", type=float, default=0.0)
    p.add_argument("--demo_reset_prob", type=float, default=0.0)
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--bc_weight", type=float, default=0.0)
    p.add_argument("--lr_decay", action="store_true",
                   help="cosine learning-rate decay over the run")
    p.add_argument("--discount", type=float, default=0.97)
    p.add_argument("--total_steps", type=int, default=200_000)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--success_stop", type=float, default=SUCCESS_STOP)
    p.add_argument("--device", type=str, default="cuda")
    return p


def make_agent(args, device):
    """The state SAC agent, with --bc_weight and, with --lr_decay, cosine
    schedules over the run's actor and critic steps."""
    opt_kwargs = {}
    if args.lr_decay:
        iters = args.total_steps // args.num_envs
        opt_kwargs = dict(
            actor_optimizer_kwargs={"learning_rate": 3e-4, "warmup_steps": 2000,
                                    "cosine_decay_steps": iters},
            critic_optimizer_kwargs={"learning_rate": 3e-4, "warmup_steps": 2000,
                                     "cosine_decay_steps": iters * args.utd_ratio},
        )
    return make_sac_agent(args.seed, obs_dim=STATE_OBS_DIM, action_dim=ACT_DIM,
                          discount=args.discount, bc_regularization=args.bc_weight,
                          device=device, **opt_kwargs)


def build(args):
    """(env, agent, rb, config, init_fn, run_chunk, demo_state, info): info
    holds the lines to print and the demos' successful and all episodes."""
    cfg = PCB_INSERT_CONFIG
    env = PandaPoseTaskEnv(config=cfg, device=args.device)
    expert = pose_expert(cfg)
    demo_state, info = None, {"lines": []}
    if args.num_demos > 0:
        demo_state, successes, episodes = expert_demos(env, expert, args.seed, args.num_demos)
        info = {"lines": [demo_line(args.num_demos, cfg.time_limit_steps, successes, episodes)],
                "demo_successes": successes, "demo_episodes": episodes}
    config = LoopConfig(
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=1,
        training_starts=args.training_starts,
        random_steps=args.random_steps,
        buffer_capacity=(100_000 // args.num_envs) * args.num_envs,
        demo_fraction=0.5 if demo_state is not None else 0.0,
        intervention_prob=args.intervention_prob,
        intervention_mode=args.intervention_mode,
        intervention_decay_steps=args.intervention_decay_steps,
        intervention_min_prob=args.intervention_min_prob,
    )
    if args.demo_reset_prob > 0.0:
        g = torch.Generator(device=env.device).manual_seed(args.seed + 5000)
        bank = collect_state_bank(env, lambda states, _: expert(states), g, num_streams=8,
                                  steps=cfg.time_limit_steps)
        env.set_demo_reset_bank(bank, args.demo_reset_prob)
        info["lines"].append(f"demo-reset bank: {bank.t.shape[0]} states "
                             f"(p={args.demo_reset_prob})")
    rb = make_state_replay_buffer(config.buffer_capacity, obs_dim=STATE_OBS_DIM,
                                  action_dim=ACT_DIM, device=env.device)
    agent = make_agent(args, env.device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=expert)
    return env, agent, rb, config, init_fn, run_chunk, demo_state, info


def main(argv=None):
    args = parser().parse_args(argv)
    env, agent, rb, config, init_fn, run_chunk, demo_state, info = build(args)
    for line in info["lines"]:
        print(line, flush=True)
    logger = Logger(description="fused_pcb_insert", output_dir=args.log_dir,
                    variant=vars(args), debug=args.debug)
    return run_fused(env, agent, rb, config, init_fn, run_chunk,
                     total_env_steps=args.total_steps, chunk_iters=CHUNK_ITERS,
                     eval_period_chunks=EVAL_PERIOD_CHUNKS, eval_episodes=args.eval_episodes,
                     seed=args.seed, demo_state=demo_state, logger=logger,
                     checkpoint_dir=args.checkpoint_dir, success_stop=args.success_stop,
                     resume=args.resume)


if __name__ == "__main__":
    main()
