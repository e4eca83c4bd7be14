"""DrQ from pixels on PandaPickCube, actor and learner in one process.

Port of `examples/fused_drq_sim.py`. Every knob comes from `WorkloadConfig`
("drq_sim", or "drq_rlpd": the recipe of the JAX package's pixel RLPD
record, 16 envs, two 128 px cameras, batch 256 x UTD 4, 2 update_high_utd
calls per env sweep, 20 demos at 50/50). `--rlpd` mixes demos 50/50 into
every batch: the scripted expert's, pixel observations rendered as the
loop renders them, collected first (num_demos + 10 episodes, noise 0.02 shared
by every env, generator seeded with seed + 7), the successful ones selected
on the device. `--encoder_type` picks the encoders: "small" (the default),
"resnet" (ResNet-10, bf16, trained), "resnet50" (ResNet-v1-50, bf16,
trained) or "resnet-pretrained" (the frozen ResNet-10 grafted from
`resnet10_params.pkl`, with a trained pooling head; a missing file raises).

    python -m serl_tpu_torch.examples.fused_drq_sim --preset drq_rlpd --seed 0 \\
        --total_env_steps 96000 --success_stop 0.9

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
from serl_tpu_torch.data.demos import collect_episodes, demos_to_buffer, select_demo_episodes
from serl_tpu_torch.examples.fused_sac_state_sim import expert_demo_policy
from serl_tpu_torch.training.config import WorkloadConfig
from serl_tpu_torch.training.launcher import make_drq_sim_experiment
from serl_tpu_torch.training.runner import eval_from_checkpoint, run_fused

PRESETS = ("drq_sim", "drq_rlpd")

# WorkloadConfig fields that this entry point does not read: the launcher
# builds the pick-cube DrQ agent with the reference hyperparameters (its
# discount is make_drq_agent's 0.96, as in the JAX example), and the
# transport's fields belong to the two-process examples (async_drq_sim.py).
# A value other than the preset's would be silently ignored, so it raises.
UNREAD_FIELDS = ("algo", "task", "image_obs", "discount", "critic_ensemble_size",
                 "critic_subsample_size", "temperature_init", "ip", "port", "steps_per_update",
                 "publish_period")


def check_supported(cfg: WorkloadConfig) -> None:
    if cfg.name not in PRESETS:
        raise ValueError(f"the pixel example runs the {' or '.join(PRESETS)} preset; "
                         f"{cfg.name!r} would be ignored here (refused, not ignored)")
    base = WorkloadConfig.preset(cfg.name)
    unread = {f: getattr(cfg, f) for f in UNREAD_FIELDS if getattr(cfg, f) != getattr(base, f)}
    if unread:
        raise ValueError(f"the pixel example runs the {cfg.name} preset's agent and task; "
                         f"these settings would be ignored (refused, not ignored): {unread}")


def scripted_pixel_demos(env, seed: int, num_demos: int, episode_len: int = 100):
    """num_demos + 10 expert episodes with pixel observations from a
    generator seeded with seed + 7; next_observations dropped (the ring
    rebuilds them), then the first num_demos successful episodes (unsuccessful
    ones where too few succeed), selected on the device. Returns those
    transitions (with `success`) and how many of the episodes succeeded."""
    g = torch.Generator(device=env.device).manual_seed(seed + 7)
    trs = collect_episodes(env, expert_demo_policy, g, num_episodes=num_demos + 10,
                           episode_len=episode_len, pixel_obs=True)
    trs.pop("next_observations")
    succeeded = int((trs["success"].reshape(-1, episode_len).amax(1) > 0.5).sum())
    return select_demo_episodes(trs, num_demos, episode_len), succeeded


def main(argv=None):
    p = argparse.ArgumentParser()
    WorkloadConfig.add_args(p, preset="drq_sim")
    p.add_argument("--rlpd", action="store_true", help="RLPD 50/50 demo mixing")
    # checkpoint-eval mode: restore --checkpoint_dir's step (-1: the latest)
    # and evaluate it instead of training
    p.add_argument("--eval_checkpoint_step", type=int, default=None)
    p.add_argument("--eval_n_trajs", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log_dir", type=str, default=None)
    args = p.parse_args(argv)
    cfg = WorkloadConfig.from_args(args)
    if args.rlpd:
        cfg = dataclasses.replace(cfg, demo_fraction=0.5)
    check_supported(cfg)
    if args.eval_checkpoint_step is not None and not cfg.checkpoint_dir:
        raise ValueError("--eval_checkpoint_step needs --checkpoint_dir")

    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=cfg.seed, encoder_type=cfg.encoder_type, image_size=cfg.image_size,
        device=args.device, **cfg.loop_overrides())
    if args.eval_checkpoint_step is not None:
        step = None if args.eval_checkpoint_step < 0 else args.eval_checkpoint_step
        return eval_from_checkpoint(env, agent, rb, cfg.checkpoint_dir, step=step,
                                    num_episodes=args.eval_n_trajs, seed=cfg.seed)
    demo_state = None
    if cfg.demo_fraction > 0.0:
        trs, succeeded = scripted_pixel_demos(env, cfg.seed, cfg.num_demos)
        demo_state = demos_to_buffer(rb, trs)
        print(f"{succeeded} of {cfg.num_demos + 10} expert episodes succeeded; loaded "
              f"{len(trs['rewards'])} pixel demo transitions (mean success "
              f"{float(trs['success'].reshape(-1, 100).amax(1).mean()):.2f})", flush=True)

    logger = Logger(description=f"fused_drq_sim_{cfg.encoder_type}"
                    + ("_rlpd" if demo_state is not None else ""),
                    output_dir=args.log_dir, variant=dataclasses.asdict(cfg), debug=cfg.debug)
    return run_fused(env, agent, rb, config, init_fn, run_chunk, demo_state=demo_state,
                     logger=logger, **cfg.runner_kwargs())


if __name__ == "__main__":
    main()
