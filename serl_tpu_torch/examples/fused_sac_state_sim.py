"""SAC from state on PandaPickCube, actor and learner in one process.

Port of `examples/fused_sac_state_sim.py`. Every knob comes from
`WorkloadConfig` (the "state_sim" preset is the recipe that solved the task
in the JAX package's record: 32 envs, batch 256 x UTD 8, 4 update_high_utd
calls per env sweep). `--rlpd` mixes demos 50/50 into every batch: the
scripted expert's, collected first (num_demos + 10 episodes, noise 0.02,
the successful ones kept), or those of `--demo_path`.

    python -m serl_tpu_torch.examples.fused_sac_state_sim --rlpd --seed 0 \\
        --total_env_steps 200000 --success_stop 0.97

Runs on the CUDA card unless `--device cpu`. Each chunk's log goes to
`--log_dir` (or the temp dir's serl_tpu_logs/) as one JSON line. With
`--checkpoint_dir D` the agent's params are saved under D (best evaluation,
every --checkpoint_period_chunks chunks, the end), touching D/PAUSE saves
the whole run and stops it, and `--resume true` goes on from there;
`--eval_checkpoint_step S --checkpoint_dir D` evaluates D's step S (-1: the
latest) instead of training.
"""

import argparse
import dataclasses

import torch

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.demos import (
    collect_episodes,
    demos_to_buffer,
    filter_successful,
    load_demos,
    take_transitions,
)
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.training.config import WorkloadConfig
from serl_tpu_torch.training.launcher import make_state_sim_experiment
from serl_tpu_torch.training.runner import eval_from_checkpoint, run_fused

DEMO_NOISE = 0.02


def expert_demo_policy(states, generator):
    """The scripted expert with exploration noise: one (4,) draw per step,
    added to every env's action (the JAX example vmaps the expert over the
    envs with one key per step, so its envs share the noise too)."""
    noise = DEMO_NOISE * torch.randn((4,), generator=generator,
                                     device=states.physics.qpos.device)
    return expert_action(states, noise)


def scripted_demos(env, seed: int, num_demos: int, episode_len: int = 100):
    """num_demos + 10 expert episodes from a generator seeded with seed + 7.
    Returns the first num_demos * episode_len transitions of the successful
    ones, and how many episodes succeeded."""
    g = torch.Generator(device=env.device).manual_seed(seed + 7)
    trs = filter_successful(collect_episodes(env, expert_demo_policy, g,
                                             num_episodes=num_demos + 10,
                                             episode_len=episode_len), episode_len)
    return take_transitions(trs, num_demos * episode_len), len(trs["rewards"]) // episode_len


# WorkloadConfig fields that this entry point does not read: the launcher
# builds the state pick-cube SAC agent with the reference hyperparameters,
# and the transport's fields belong to the two-process examples
# (async_sac_state_sim.py). A value other than the state_sim preset's would
# be silently ignored, so it raises (`name` is the preset's: --preset picks
# it).
UNREAD_FIELDS = ("name", "algo", "task", "image_obs", "image_size", "encoder_type", "discount",
                 "critic_ensemble_size", "critic_subsample_size", "temperature_init", "ip",
                 "port", "steps_per_update", "publish_period")


def check_supported(cfg: WorkloadConfig) -> None:
    base = WorkloadConfig.preset("state_sim")
    unread = {f: getattr(cfg, f) for f in UNREAD_FIELDS if getattr(cfg, f) != getattr(base, f)}
    if unread:
        raise ValueError(f"the state example runs the state_sim preset's agent and task; "
                         f"these settings would be ignored (refused, not ignored): {unread}")


def main(argv=None):
    p = argparse.ArgumentParser()
    WorkloadConfig.add_args(p, preset="state_sim")
    p.add_argument("--rlpd", action="store_true", help="RLPD 50/50 demo mixing")
    p.add_argument("--demo_path", type=str, default=None)
    # checkpoint-eval mode: restore --checkpoint_dir's step (-1: the latest)
    # and evaluate it instead of training
    p.add_argument("--eval_checkpoint_step", type=int, default=None)
    p.add_argument("--eval_n_trajs", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log_dir", type=str, default=None)
    args = p.parse_args(argv)
    cfg = WorkloadConfig.from_args(args)
    if args.rlpd or args.demo_path:
        cfg = dataclasses.replace(cfg, demo_fraction=0.5)
    check_supported(cfg)
    if args.eval_checkpoint_step is not None and not cfg.checkpoint_dir:
        raise ValueError("--eval_checkpoint_step needs --checkpoint_dir")

    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=cfg.seed, device=args.device, **cfg.loop_overrides())
    if args.eval_checkpoint_step is not None:
        step = None if args.eval_checkpoint_step < 0 else args.eval_checkpoint_step
        return eval_from_checkpoint(env, agent, rb, cfg.checkpoint_dir, step=step,
                                    num_episodes=args.eval_n_trajs, seed=cfg.seed)
    demo_state = None
    if cfg.demo_fraction > 0.0:
        if args.demo_path:
            trs = load_demos(args.demo_path)
        else:
            trs, succeeded = scripted_demos(env, cfg.seed, cfg.num_demos)
            print(f"{succeeded} of {cfg.num_demos + 10} expert episodes succeeded", flush=True)
        demo_state = demos_to_buffer(rb, trs)
        print(f"loaded {len(trs['rewards'])} demo transitions", flush=True)

    logger = Logger(description="fused_sac_state_sim" + ("_rlpd" if demo_state is not None else ""),
                    output_dir=args.log_dir, variant=dataclasses.asdict(cfg), debug=cfg.debug)
    return run_fused(env, agent, rb, config, init_fn, run_chunk, demo_state=demo_state,
                     logger=logger, **cfg.runner_kwargs())


if __name__ == "__main__":
    main()
