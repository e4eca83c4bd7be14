"""Policy evaluation over lockstep episodes.

Port of `evaluate_batched` from `serl_tpu/common/evaluation.py`: N episodes
of a batched env rolled out together for `episode_len` steps (no early
stop, as the JAX package's scan), with the agent's mode (`argmax`) or a
draw per step, returning the mean and (population) std of the returns and
the share of episodes that succeeded at some step. (`supply_rng`,
`flatten_info`, the gym-loop `evaluate`, `evaluate_with_trajectories` and
`bootstrap_std` wait for a caller.)
"""

from typing import Callable, Dict, Optional

import torch

from serl_tpu_torch.envs.panda_pick import flatten_obs


@torch.no_grad()
def evaluate_batched(env, agent, generator: Optional[torch.Generator] = None,
                     num_episodes: int = 32, episode_len: int = 100, argmax: bool = True,
                     obs_fn: Optional[Callable] = None) -> Dict[str, float]:
    """`num_episodes` lockstep episodes of `env` under `agent`; resets (and
    the actions' draws, without `argmax`) from `generator`, on the env's
    device. `obs_fn` maps the env's observation to the agent's input (the
    flat state by default)."""
    obs_fn = obs_fn or flatten_obs
    states, obs = env.reset(num_episodes, generator)
    ret = torch.zeros((num_episodes,), device=env.device)
    succ = torch.zeros((num_episodes,), device=env.device)
    for _ in range(episode_len):
        a_obs = obs_fn(obs)
        if argmax:
            actions = agent.sample_actions(a_obs, argmax=True)
        else:
            actions = agent.sample_actions(a_obs, generator=generator)
        states, obs, r, _, info = env.step(states, actions)
        ret = ret + r
        succ = torch.maximum(succ, info["success"])
    return {
        "return_mean": float(ret.mean()),
        "return_std": float(ret.std(unbiased=False)),
        "success_rate": float(succ.mean()),
    }
