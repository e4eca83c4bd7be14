"""Online VICE: the policy learns from a GAN-style goal classifier only.

Port of `examples/vice_online.py`, with its flags and defaults:
  1. goal frames (`collect_goal_images`): the pose expert with noise 0.05
     per env, parked at the success pose (8 streams without auto-reset),
     both cameras, the frames where it succeeded (at least 64);
  2. DrQ online on the CABLE_ROUTE_CONFIG pose task (16 envs, two 128 px
     cameras, small encoders, batch 256 x UTD 4, 2 update_high_utd calls an
     iteration, the 20,000-row uint8 ring, discount 0.97 and otherwise
     `create_drq`'s defaults as in the JAX example: 2 critics, swish MLPs
     without LayerNorm, a state-independent std, temperature 1; the expert
     owning whole episodes with probability 0.3 decayed over 40k env steps), the
     critic's reward the VICE classifier's sigmoid >= 0.5 on the front
     camera's next observation (`VICEAgent.update_high_utd`);
  3. between chunks of 10 iterations, --vice_updates_per_chunk
     `update_vice` calls on batches of 64 policy frames (80 sampled from the
     ring, the first 64 kept) then 64 goal frames (`vice_batch`).
The env's `dense_shaping` is set only to turn off the early termination on
success: episodes end at the time limit, and the stored env rewards are
never read. Every --eval_period env steps, 16 argmax episodes report the
ground-truth pose success and the share of episodes the classifier rated a
success at some step; solved at two ground-truth evaluations in a row at
--success_stop (the JAX example's fixed 0.9).

    python -m serl_tpu_torch.examples.vice_online --total_steps 120000

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import sys
import time

import torch

from serl_tpu_torch.agents.vice import VICEAgent
from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.demos import collect_episodes
from serl_tpu_torch.envs.tasks import CABLE_ROUTE_CONFIG, PIXEL_STATE_DIM, PandaPoseTaskEnv
from serl_tpu_torch.envs.wrappers import add_stack_axis, serl_obs
from serl_tpu_torch.examples.fused_cable_route import noisy_expert
from serl_tpu_torch.examples.fused_peg_insert import pose_expert
from serl_tpu_torch.training.launcher import make_pixel_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop

IMAGE_KEYS = ("front", "wrist")
VICE_KEYS = ("front",)
ACT_DIM = 7
MIN_GOALS = 64
EVAL_EPISODES = 16
CHUNK = 10


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--vice_updates_per_chunk", type=int, default=4)
    p.add_argument("--vice_batch", type=int, default=128)
    p.add_argument("--intervention_prob", type=float, default=0.3)
    p.add_argument("--intervention_decay_steps", type=int, default=40_000)
    p.add_argument("--total_steps", type=int, default=120_000)
    p.add_argument("--eval_period", type=int, default=4000)
    p.add_argument("--success_stop", type=float, default=0.9)
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def collect_goal_images(env, expert, seed: int, streams: int = 8):
    """({camera: (M, H, W, 3) uint8} goal frames on the env's device, M)."""
    g = torch.Generator(device=env.device).manual_seed(seed + 2000)
    trs = collect_episodes(env, noisy_expert(expert, 0.05), g, num_episodes=streams,
                           episode_len=env.time_limit_steps, pixel_obs=True,
                           auto_reset=False)  # parked at the goal: dense at-goal frames
    succ = trs["success"] > 0.5
    goals = {k: trs["observations"][k][succ] for k in IMAGE_KEYS}
    return goals, goals[IMAGE_KEYS[0]].shape[0]


def vice_batch(rb, rb_state, goals, n_goals: int, num_envs: int, b: int, g):
    """{"next_observations": ...}: rows [0, b/2) policy frames (the first b/2
    of a ring sample rounded up past b/2 to whole streams), rows [b/2, b)
    goal frames at uniform indices, the state the policy rows' twice."""
    online = rb.sample(rb_state, (b // 2 // num_envs + 1) * num_envs, generator=g)
    idx = torch.randint(0, n_goals, (b // 2,), generator=g, device=rb_state.ep_id.device)
    nxt = {}
    for k in IMAGE_KEYS:
        pol = online["next_observations"][k][: b // 2]
        goal = goals[k][idx]
        if goal.dim() == pol.dim() - 1:  # the sampled batches' (B, T=1, H, W, C) layout
            goal = goal.unsqueeze(1)
        nxt[k] = torch.cat([pol, goal], 0)
    nxt["state"] = torch.cat([online["next_observations"]["state"][: b // 2]] * 2, 0)
    return {"next_observations": nxt}


def build(args, out=sys.stdout):
    """(env, agent, rb, config, init_fn, run_chunk, goals, n_goals)."""
    cfg = CABLE_ROUTE_CONFIG
    env = PandaPoseTaskEnv(config=cfg, image_obs=True, render_size=args.image_size,
                           device=args.device)
    env.dense_shaping = True  # only to turn off the early termination on success
    expert = pose_expert(cfg)
    goals, n_goals = collect_goal_images(env, expert, args.seed)
    print(f"goal set: {n_goals} at-goal frames", file=out, flush=True)
    if n_goals < MIN_GOALS:
        raise RuntimeError(f"the expert collected {n_goals} goal frames, fewer than {MIN_GOALS}")
    config = LoopConfig(
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=2,
        training_starts=1000,
        random_steps=1000,
        buffer_capacity=(20_000 // args.num_envs) * args.num_envs,
        intervention_prob=args.intervention_prob,
        intervention_mode="episode",
        intervention_decay_steps=args.intervention_decay_steps,
    )
    rb = make_pixel_replay_buffer(capacity=config.buffer_capacity, image_keys=IMAGE_KEYS,
                                  image_size=args.image_size, state_dim=PIXEL_STATE_DIM,
                                  action_dim=ACT_DIM, device=env.device)
    size = args.image_size
    sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
              **{k: torch.zeros((1, 1, size, size, 3), dtype=torch.uint8) for k in IMAGE_KEYS}}
    agent = VICEAgent.create_vice(
        sample, torch.zeros((1, ACT_DIM)), encoder_type="small", image_keys=IMAGE_KEYS,
        vice_image_keys=VICE_KEYS, discount=0.97,
        generator=torch.Generator().manual_seed(args.seed), device=env.device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=expert)
    return env, agent, rb, config, init_fn, run_chunk, goals, n_goals


@torch.no_grad()
def eval_rollout(env, agent, seed: int, num_episodes: int = EVAL_EPISODES):
    """(ground-truth pose success, share of episodes the classifier rated a
    success at some step) of `num_episodes` argmax episodes."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    states, obs = env.reset(num_episodes, g)
    p_succ = torch.zeros((num_episodes,), device=env.device)
    v_rate = torch.zeros_like(p_succ)
    for _ in range(env.time_limit_steps):
        actions = agent.sample_actions(add_stack_axis(serl_obs(obs), IMAGE_KEYS), argmax=True)
        states, obs, _, _, info = env.step(states, actions)
        v = agent.vice_reward(add_stack_axis(serl_obs(obs), IMAGE_KEYS))
        p_succ = torch.maximum(p_succ, info["success"])
        v_rate = torch.maximum(v_rate, (v >= 0.5).to(torch.float32))
    return float(p_succ.mean()), float(v_rate.mean())


def main(argv=None):
    args = parser().parse_args(argv)
    out = open(args.log, "a") if args.log else sys.stdout
    env, agent, rb, config, init_fn, run_chunk, goals, n_goals = build(args, out)
    logger = Logger(description="vice_online", output_dir=args.log_dir, variant=vars(args))
    carry = init_fn(agent, args.seed)
    g = torch.Generator(device=env.device).manual_seed(args.seed + 5)
    eval_every = max(args.eval_period // (config.num_envs * CHUNK), 1)
    t0 = time.time()
    n_chunks, consecutive, vinfo = 0, 0, {}
    while carry.env_steps < args.total_steps:
        carry, m = run_chunk(carry, CHUNK)
        n_chunks += 1
        # the online adversarial classifier updates between chunks
        for _ in range(args.vice_updates_per_chunk):
            batch = vice_batch(rb, carry.rb_state, goals, n_goals, args.num_envs,
                               args.vice_batch, g)
            _, vinfo = carry.agent.update_vice(batch, generator=g)
        if n_chunks % eval_every:
            continue
        steps = carry.env_steps
        p_succ, v_rate = eval_rollout(env, carry.agent, steps)
        bce = float(vinfo["vice"]["bce_loss"])
        rate = steps / (time.time() - t0)
        print(f"steps {steps} ({rate:.0f}/s) vice_bce {bce:.3f} eval_vice_rate {v_rate:.2f} "
              f"eval_pose_succ {p_succ:.2f}", file=out, flush=True)
        logger.log({"env_steps": steps, "env_steps_per_s": rate, "vice/bce_loss": bce,
                    "vice/grad_norm": float(vinfo["vice"]["grad_norm"]),
                    "eval/success_rate": p_succ, "eval/vice_rate": v_rate}, step=steps)
        consecutive = consecutive + 1 if p_succ >= args.success_stop else 0
        if consecutive >= 2:
            print(f"SOLVED at {steps} env steps ({time.time() - t0:.0f}s): a policy trained on "
                  f"the VICE reward only reaches ground-truth success on 2 consecutive evals",
                  file=out, flush=True)
            break
    logger.close()
    return carry


if __name__ == "__main__":
    main()
