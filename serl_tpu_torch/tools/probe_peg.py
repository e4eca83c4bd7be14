"""Diagnostic probe of the peg-insertion recipe from states.

Port of the JAX package's `tools/probe_peg.py`, with its flags and defaults.
It trains peg insertion as `examples/fused_peg_insert.py` does (the
PEG_INSERT_CONFIG pose task, 20 demo streams of the scripted pose expert
mixed 50/50 into every batch, the expert owning whole episodes with
probability 0.3, 16 envs, batch 256 x UTD 4, discount 0.97) and, after each
chunk of `eval_period` env steps, prints where learning stalls:
  * Q on the demo rows with reward > 0 (`Q_pos`): the critic must drive
    them to ~1, or the demo signal is not consumed;
  * Q on the demos' first rows (`Q_early`): value must propagate back;
  * the temperature (`alpha`) and the policy's entropy (`H`): a runaway
    alpha keeps the argmax policy hovering;
  * the argmax policy's success on 32 episodes and its final pose error per
    dimension (xyz, and rpy wrapped to [0, pi]): which success dim fails.

`probe_q` and `eval_pose_error` are the two readings (closures inside the
JAX tool's `main`).

    python -m serl_tpu_torch.tools.probe_peg --total_steps 24000 --intervention_prob 0.3

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.data.demos import collect_episodes, demos_to_buffer
from serl_tpu_torch.envs.panda_pick import flatten_obs
from serl_tpu_torch.envs.physics.arm import fk
from serl_tpu_torch.envs.scripted_expert import pose_expert_action
from serl_tpu_torch.envs.tasks import PEG_INSERT_CONFIG, PandaPoseTaskEnv, ResetDraws
from serl_tpu_torch.training.launcher import make_sac_agent, make_state_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop

OBS_DIM, ACT_DIM = 13, 7
PROBE_ROWS = 256  # at most this many reward > 0 demo rows in Q_pos's batch
EVAL_EPISODES = 32


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--intervention_prob", type=float, default=0.3)
    p.add_argument("--intervention_mode", default="episode")
    p.add_argument("--intervention_decay_steps", type=int, default=None)
    p.add_argument("--discount", type=float, default=0.97)
    p.add_argument("--total_steps", type=int, default=24000)
    p.add_argument("--eval_period", type=int, default=4000)
    p.add_argument("--device", default="cuda")
    return p


def loop_config(args) -> LoopConfig:
    """The probe's loop: the JAX tool's settings (1,000 random steps and
    rows before learning, a 100,000-row ring, half-demo batches)."""
    return LoopConfig(
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=1,
        training_starts=1000,
        random_steps=1000,
        buffer_capacity=(100_000 // args.num_envs) * args.num_envs,
        demo_fraction=0.5,
        intervention_prob=args.intervention_prob,
        intervention_mode=args.intervention_mode,
        intervention_decay_steps=args.intervention_decay_steps,
    )


def probe_batches(trans: Dict[str, torch.Tensor], episode_len: int):
    """(probe_pos, probe_early): the observations and actions of the first
    PROBE_ROWS demo rows with reward > 0, and of every stream's first row."""
    rew = trans["rewards"]
    pos_idx = torch.nonzero(rew > 0).flatten()[:PROBE_ROWS]
    early_idx = torch.arange(0, rew.shape[0], episode_len, device=rew.device)
    pick = lambda idx: {k: trans[k][idx] for k in ("observations", "actions")}
    return pick(pos_idx), pick(early_idx)


@torch.no_grad()
def probe_q(agent, probe_pos: Dict, probe_early: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The critic ensemble's mean Q over each probe batch (0-d tensors)."""
    return tuple(agent.forward_critic(b["observations"], b["actions"]).mean()
                 for b in (probe_pos, probe_early))


@torch.no_grad()
def eval_pose_error(agent, env: PandaPoseTaskEnv, draws: ResetDraws):
    """The argmax policy over one episode of the envs reset by `draws`:
    (success rate, a 0-d tensor; the (6,) mean final |pose - target|, the
    angles wrapped to [0, pi])."""
    n = draws.xy.shape[0]
    states, obs = env.reset(n, draws=draws)
    succ = torch.zeros((n,), device=env.device)
    for _ in range(env.config.time_limit_steps):
        actions = agent.sample_actions(flatten_obs(obs), argmax=True)
        states, obs, _, _, info = env.step(states, actions)
        succ = torch.maximum(succ, info["success"])
    pose = env._pose(fk(states.physics.qpos))
    err = (pose - torch.tensor(env.config.target_pose, device=env.device)).abs()
    err = torch.cat([err[:, :3], torch.minimum(err[:, 3:], 2 * math.pi - err[:, 3:])], -1)
    return succ.mean(), err.mean(0)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """Train and probe; returns each chunk's printed numbers as a dict."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = PEG_INSERT_CONFIG
    env = PandaPoseTaskEnv(config=cfg, device=device)
    expert = lambda s: pose_expert_action(s, cfg.target_pose, cfg.action_scale)

    g = torch.Generator(device=device).manual_seed(args.seed + 1000)
    trans = collect_episodes(env, lambda states, _: expert(states), g,
                             num_episodes=args.num_demos, episode_len=cfg.time_limit_steps,
                             auto_reset=True)
    succ = float(trans.pop("success").mean())
    print(f"demo mean per-step success {succ:.3f}")
    rew = trans["rewards"]
    print(f"demo transitions: {rew.shape[0]}, episodes {float(trans['dones'].sum()):.0f}, "
          f"reward>0 frac {float((rew > 0).float().mean()):.3f}, mask0 frac "
          f"{float((trans['masks'] < 0.5).float().mean()):.3f}")
    demo_rb = make_state_replay_buffer(args.num_demos * cfg.time_limit_steps, obs_dim=OBS_DIM,
                                       action_dim=ACT_DIM, device=device)
    demo_state = demos_to_buffer(demo_rb, trans, episode_len=cfg.time_limit_steps)
    probe_pos, probe_early = probe_batches(trans, cfg.time_limit_steps)

    config = loop_config(args)
    rb = make_state_replay_buffer(config.buffer_capacity, obs_dim=OBS_DIM, action_dim=ACT_DIM,
                                  device=device)
    agent = make_sac_agent(args.seed, obs_dim=OBS_DIM, action_dim=ACT_DIM,
                           discount=args.discount, device=device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=expert)
    carry = init_fn(agent, args.seed, demo_state=demo_state)

    chunk = max(args.eval_period // config.num_envs, 1)
    t0 = time.time()
    prev_ep, prev_suc, records = 0, 0.0, []
    while carry.env_steps < args.total_steps:
        carry, m = run_chunk(carry, chunk)
        steps = carry.env_steps
        ep = int(m["ep_count"][-1])
        suc = float(m["succ_sum"][-1])
        train_succ = (suc - prev_suc) / max(ep - prev_ep, 1)
        prev_ep, prev_suc = ep, suc
        q_pos, q_early = probe_q(carry.agent, probe_pos, probe_early)
        draws = env.sample_reset_draws(
            EVAL_EPISODES, torch.Generator(device=device).manual_seed(steps))
        ev_succ, ev_err = eval_pose_error(carry.agent, env, draws)
        err = ev_err.tolist()
        rec = {"steps": steps, "rate": steps / (time.time() - t0), "train_succ": train_succ,
               "eval_succ": float(ev_succ), "Q_pos": float(q_pos), "Q_early": float(q_early),
               "alpha": float(m["temperature"][-1]), "H": float(m["entropy"][-1]), "err": err}
        records.append(rec)
        print(f"steps {steps} ({rec['rate']:.0f}/s) "
              f"train_succ {train_succ:.2f} eval_succ {rec['eval_succ']:.2f} | "
              f"Q_pos {rec['Q_pos']:.3f} Q_early {rec['Q_early']:.3f} "
              f"alpha {rec['alpha']:.4f} H {rec['H']:.2f} | "
              f"err xyz {err[0]:.3f},{err[1]:.3f},{err[2]:.3f} "
              f"rpy {err[3]:.3f},{err[4]:.3f},{err[5]:.3f}",
              flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
