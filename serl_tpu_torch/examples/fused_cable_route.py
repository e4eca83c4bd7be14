"""Cable route: DrQ + RLPD whose only reward is a learned classifier.

Port of `examples/fused_cable_route.py`, with its flags and defaults. Two
phases in one run:
  1. the reward classifier (`train_classifier`): front-camera frames of the
     CABLE_ROUTE_CONFIG pose task, the positives from the pose expert with
     noise 0.05 per env at the success pose (8 streams WITHOUT auto-reset,
     so it sits at the goal), the negatives that same rollout's approach
     frames, a sloppier expert's (noise 0.5 per env, auto-reset) and a
     random policy's (one hard-coded (8, 7) draw a step) frames that did not
     succeed; --classifier_epochs steps of 64 + 64 frames, each batch cropped
     by K3 (pad 4, one window per (batch, stack) image);
  2. RL through `ClassifierRewardEnv` at threshold 0.75 (the classifier's
     verdict on the stepped front frame is the reward and ends the
     episode): 20 auto-reset expert demo streams through the wrapper mixed
     50/50 into every batch, the expert owning whole episodes with
     probability 0.3, 16 envs, two 128 px cameras, small encoders, batch
     256 x UTD 4, 2 update_high_utd calls an iteration, the 20,000-row uint8
     ring, 10 critics subsampled to 2.

Every --eval_period env steps (chunks of 10 iterations) an evaluation of 16
argmax episodes reports both the classifier's success and the ground-truth
pose success, so reward hacking shows; the run is solved when both reach
--success_stop (the JAX example's fixed 0.9) on two evaluations in a row.
Lines go to --log (default stdout), each evaluation's numbers to --log_dir
as a JSON line.

    python -m serl_tpu_torch.examples.fused_cable_route --total_steps 60000

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import sys
import time

import torch

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.demos import collect_episodes, demos_to_buffer
from serl_tpu_torch.envs.tasks import CABLE_ROUTE_CONFIG, PIXEL_STATE_DIM, PandaPoseTaskEnv
from serl_tpu_torch.envs.wrappers import ClassifierRewardEnv, add_stack_axis, serl_obs
from serl_tpu_torch.examples.fused_peg_insert import pose_expert
from serl_tpu_torch.networks.classifier import (
    classifier_fn,
    classifier_train_step,
    create_classifier,
)
from serl_tpu_torch.training.launcher import make_drq_agent, make_pixel_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop
from serl_tpu_torch.vision.augmentations import crop_images, crop_offsets

ACT_DIM = 7
IMAGE_KEYS = ("front", "wrist")
CLS_KEY = "front"
THRESHOLD = 0.75  # the wrapped reward fires only on confident positives
CLASSIFIER_HALF = 64  # positives and negatives per classifier step
CLASSIFIER_STREAMS = 8  # streams of each kind of classifier frames
EVAL_EPISODES = 16
CHUNK = 10


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    # 128 px, the reference's camera size: at 64 px the classifier cannot
    # resolve the 2 cm success threshold
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--classifier_epochs", type=int, default=300)
    p.add_argument("--intervention_prob", type=float, default=0.3)
    p.add_argument("--total_steps", type=int, default=60_000)
    p.add_argument("--eval_period", type=int, default=4000)
    p.add_argument("--success_stop", type=float, default=0.9)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def noisy_expert(expert, scale: float):
    """The expert plus `scale` x a standard-normal (N, 7) draw, per env."""

    def policy(states, g):
        n = states.t.shape[0]
        noise = scale * torch.randn((n, ACT_DIM), generator=g, device=states.t.device)
        return torch.clamp(expert(states) + noise, -1.0, 1.0)

    return policy


def random_policy(states, g):
    """Uniform actions, one hard-coded (8, 7) draw a step (the JAX example's)."""
    return torch.rand((8, ACT_DIM), generator=g, device=states.t.device) * 2.0 - 1.0


def classifier_frames(env, expert, seed: int, streams: int = CLASSIFIER_STREAMS):
    """(positives, negatives) front frames as (M, 1, H, W, 3) uint8 on the
    env's device, from the three rollouts of the module docstring."""
    limit = env.time_limit_steps

    def roll(policy, offset, auto_reset):
        g = torch.Generator(device=env.device).manual_seed(seed + offset)
        return collect_episodes(env, policy, g, num_episodes=streams, episode_len=limit,
                                pixel_obs=True, auto_reset=auto_reset)

    exp_trs = roll(noisy_expert(expert, 0.05), 2000, False)  # sits at the goal: dense positives
    miss_trs = roll(noisy_expert(expert, 0.5), 4000, True)  # hovers around the site
    neg_trs = roll(random_policy, 3000, True)
    exp_succ = exp_trs["success"] > 0.5
    exp_px = exp_trs["observations"][CLS_KEY]
    pos = exp_px[exp_succ][:, None]
    rand_px = neg_trs["observations"][CLS_KEY][neg_trs["success"] < 0.5]
    miss_px = miss_trs["observations"][CLS_KEY][miss_trs["success"] < 0.5]
    neg = torch.cat([exp_px[~exp_succ], miss_px, rand_px], 0)[:, None]
    return pos, neg


def train_classifier(env, expert, args, out, frames=None, epochs=None):
    """Phase 1: returns (classifier state, {"positives", "negatives",
    "first_loss", and "loss", "accuracy" of the last step}). `frames` (positives, negatives)
    skips the collection; `epochs` overrides --classifier_epochs."""
    pos, neg = frames if frames is not None else classifier_frames(env, expert, args.seed)
    print(f"classifier data: {pos.shape[0]} positives, {neg.shape[0]} negatives", file=out,
          flush=True)
    state = create_classifier({CLS_KEY: pos[:1]}, (CLS_KEY,), encoder_type="small",
                              generator=torch.Generator().manual_seed(args.seed),
                              device=env.device)
    g = torch.Generator(device=env.device).manual_seed(args.seed + 1)
    n_half = CLASSIFIER_HALF
    labels = torch.cat([torch.ones(n_half, device=env.device),
                        torch.zeros(n_half, device=env.device)])
    epochs = args.classifier_epochs if epochs is None else epochs
    info, first_loss = {}, None
    for epoch in range(epochs):
        pi = torch.randint(0, pos.shape[0], (n_half,), generator=g, device=env.device)
        ni = torch.randint(0, neg.shape[0], (n_half,), generator=g, device=env.device)
        px = torch.cat([pos[pi], neg[ni]], 0)
        px = crop_images([px], [crop_offsets(2 * n_half, 4, g, env.device)], padding=4,
                         num_batch_dims=2)[0]
        state, info = classifier_train_step(
            state, {"observations": {CLS_KEY: px}, "labels": labels}, generator=g)
        if epoch == 0:
            first_loss = float(info["loss"])
        if epoch % 20 == 0 or epoch == epochs - 1:
            print(f"classifier epoch {epoch} loss {float(info['loss']):.4f} "
                  f"acc {float(info['accuracy']):.3f}", file=out, flush=True)
    return state, {"positives": pos.shape[0], "negatives": neg.shape[0], "first_loss": first_loss,
                   "loss": float(info["loss"]) if info else None,
                   "accuracy": float(info["accuracy"]) if info else None}


def wrapped_demos(wrapped, expert, seed: int, num_demos: int):
    """num_demos auto-reset expert streams through the wrapper (no noise) as a
    write-once uint8 demo ring. Returns (ring state, classifier-success
    steps, episodes)."""
    limit = wrapped.time_limit_steps
    g = torch.Generator(device=wrapped.device).manual_seed(seed + 1000)
    trans = collect_episodes(wrapped, lambda states, _: expert(states), g,
                             num_episodes=num_demos, episode_len=limit, pixel_obs=True,
                             auto_reset=True)
    successes = int(trans.pop("success").sum())
    episodes = int(trans["dones"].sum())
    trans.pop("next_observations")  # the ring rebuilds them
    demo_rb = make_pixel_replay_buffer(capacity=num_demos * limit, image_keys=IMAGE_KEYS,
                                       image_size=wrapped.render_size,
                                       state_dim=PIXEL_STATE_DIM, action_dim=ACT_DIM,
                                       device=wrapped.device)
    return demos_to_buffer(demo_rb, trans, limit), successes, episodes


def loop_config(args, demos: bool) -> LoopConfig:
    return LoopConfig(
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=2,
        training_starts=1000,
        random_steps=1000,
        buffer_capacity=(20_000 // args.num_envs) * args.num_envs,
        demo_fraction=0.5 if demos else 0.0,
        intervention_prob=args.intervention_prob,
        intervention_mode="episode",
    )


def build(args, out=sys.stdout, classifier=None):
    """(env, wrapped, agent, rb, config, init_fn, run_chunk, demo_state,
    info): phase 1 (unless `classifier`, a trained classifier state, is
    given), the wrapper, the demos and the loop. info holds the lines
    printed, the classifier's state and data counts, and the demos'
    classifier-success steps and episodes."""
    cfg = CABLE_ROUTE_CONFIG
    env = PandaPoseTaskEnv(config=cfg, image_obs=True, render_size=args.image_size,
                           device=args.device)
    expert = pose_expert(cfg)
    info = {"classifier": None}
    if classifier is None:
        classifier, info["classifier"] = train_classifier(env, expert, args, out)
    info["classifier_state"] = classifier
    wrapped = ClassifierRewardEnv(env, classifier_fn(classifier), image_key=CLS_KEY,
                                  threshold=THRESHOLD)
    demo_state = None
    if args.num_demos > 0:
        demo_state, successes, episodes = wrapped_demos(wrapped, expert, args.seed,
                                                        args.num_demos)
        steps = args.num_demos * cfg.time_limit_steps
        print(f"demos: {steps} transitions, {episodes} episodes, classifier-success-step frac "
              f"{successes / steps:.2f}", file=out, flush=True)
        info.update(demo_successes=successes, demo_episodes=episodes)
    config = loop_config(args, demo_state is not None)
    rb = make_pixel_replay_buffer(capacity=config.buffer_capacity, image_keys=IMAGE_KEYS,
                                  image_size=args.image_size, state_dim=PIXEL_STATE_DIM,
                                  action_dim=ACT_DIM, device=env.device)
    size = args.image_size
    sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
              **{k: torch.zeros((1, 1, size, size, 3), dtype=torch.uint8) for k in IMAGE_KEYS}}
    agent = make_drq_agent(args.seed, sample, torch.zeros((1, ACT_DIM)), image_keys=IMAGE_KEYS,
                           encoder_type="small", device=env.device)
    init_fn, run_chunk = make_fused_loop(wrapped, rb, config, expert_fn=expert)
    return env, wrapped, agent, rb, config, init_fn, run_chunk, demo_state, info


@torch.no_grad()
def eval_rollout(wrapped, agent, seed: int, num_episodes: int = EVAL_EPISODES):
    """(classifier success, ground-truth pose success) of `num_episodes`
    argmax episodes, each the time limit long (no auto-reset)."""
    g = torch.Generator(device=wrapped.device).manual_seed(seed)
    states, obs = wrapped.reset(num_episodes, g)
    c_succ = torch.zeros((num_episodes,), device=wrapped.device)
    p_succ = torch.zeros_like(c_succ)
    for _ in range(wrapped.time_limit_steps):
        actions = agent.sample_actions(add_stack_axis(serl_obs(obs), IMAGE_KEYS), argmax=True)
        states, obs, _, _, info = wrapped.step(states, actions)
        c_succ = torch.maximum(c_succ, info["success"])
        p_succ = torch.maximum(p_succ, info["pose_success"])
    return float(c_succ.mean()), float(p_succ.mean())


def main(argv=None):
    args = parser().parse_args(argv)
    out = open(args.log, "a") if args.log else sys.stdout
    env, wrapped, agent, rb, config, init_fn, run_chunk, demo_state, info = build(args, out)
    logger = Logger(description="fused_cable_route", output_dir=args.log_dir,
                    variant=vars(args))
    logger.log({f"classifier/{k}": v for k, v in info["classifier"].items()}, step=0)
    carry = init_fn(agent, args.seed, demo_state=demo_state)
    eval_every = max(args.eval_period // (config.num_envs * CHUNK), 1)
    t0 = time.time()
    prev_ep, prev_suc, n_chunks, solve_streak = 0, 0.0, 0, 0
    while carry.env_steps < args.total_steps:
        carry, m = run_chunk(carry, CHUNK)
        n_chunks += 1
        if n_chunks % eval_every:
            continue
        steps = carry.env_steps
        ep, suc = int(m["ep_count"][-1]), float(m["succ_sum"][-1])
        train_succ = (suc - prev_suc) / max(ep - prev_ep, 1)
        prev_ep, prev_suc = ep, suc
        c_succ, p_succ = eval_rollout(wrapped, carry.agent, steps)
        rate = steps / (time.time() - t0)
        print(f"steps {steps} ({rate:.0f}/s) train_succ {train_succ:.2f} "
              f"eval_classifier_succ {c_succ:.2f} eval_pose_succ {p_succ:.2f}",
              file=out, flush=True)
        logger.log({"env_steps": steps, "env_steps_per_s": rate,
                    "train/success_rate": train_succ, "eval/success_rate": p_succ,
                    "eval/classifier_success_rate": c_succ}, step=steps)
        # solved: both evaluations at the bar, twice in a row
        ok = c_succ >= args.success_stop and p_succ >= args.success_stop
        solve_streak = solve_streak + 1 if ok else 0
        if solve_streak >= 2:
            print(f"SOLVED (both evals >= {args.success_stop} on 2 consecutive rounds) at "
                  f"{steps} env steps ({time.time() - t0:.0f}s): classifier reward and ground "
                  f"truth agree", file=out, flush=True)
            break
    logger.close()
    return carry


if __name__ == "__main__":
    main()
