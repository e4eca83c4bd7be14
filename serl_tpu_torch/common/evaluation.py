"""Policy evaluation.

Port of `serl_tpu/common/evaluation.py`:

  * `evaluate_batched`: N episodes of a batched env rolled out together for
    `episode_len` steps (no early stop, as the JAX package's scan), with
    the agent's mode (`argmax`) or a draw per step, returning the mean and
    (population) std of the returns and the share of episodes that
    succeeded at some step;
  * the gym-API loops `evaluate` and `evaluate_with_trajectories` for
    adapter envs (`envs/gym_adapter.py`), averaging the scalar entries of
    each episode's final info under "final." keys (`flatten_info`);
  * `supply_rng`, which hands a wrapped function one generator for its
    draws, and `bootstrap_std`, whose resampling indices are the caller's
    (or numpy's global draws, as the JAX function's).
"""

from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from serl_tpu_torch.envs.panda_pick import flatten_obs


def supply_rng(f, rng: Optional[torch.Generator] = None):
    """`f` with `generator=` supplied on every call: one generator (`rng`,
    or a fresh one seeded from numpy's global state as the JAX function
    seeds its key) that each call's draws advance, where the JAX function
    splits a new key per call."""
    g = rng if rng is not None else torch.Generator().manual_seed(np.random.randint(2 ** 31))

    def wrapped(*args, **kwargs):
        return f(*args, generator=g, **kwargs)

    return wrapped


def flatten_info(d: Dict, parent_key: str = "", sep: str = ".") -> Dict:
    """A nested dict flattened to `sep`-joined keys."""
    items = []
    for k, v in d.items():
        key = parent_key + sep + k if parent_key else k
        if isinstance(v, dict):
            items.extend(flatten_info(v, key, sep).items())
        else:
            items.append((key, v))
    return dict(items)


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


def _final_stats(stats, info) -> None:
    for k, v in flatten_info(info, parent_key="final").items():
        if np.isscalar(v) or np.ndim(v) == 0:
            stats[k].append(v)


def evaluate(policy_fn, env, num_episodes: int) -> Dict[str, float]:
    """Gym-API loop evaluation: `num_episodes` episodes of `env` (reset,
    step until terminated or truncated) under `policy_fn(obs) -> action`;
    the mean of every scalar entry of each episode's final info, under
    "final." keys."""
    stats = defaultdict(list)
    for _ in range(num_episodes):
        obs, info = env.reset()
        done = False
        while not done:
            action = policy_fn(obs)
            obs, r, terminated, truncated, info = env.step(np.asarray(action))
            done = bool(terminated or truncated)
        _final_stats(stats, info)
    return {k: float(np.mean(v)) for k, v in stats.items()}


def evaluate_with_trajectories(policy_fn, env, num_episodes: int):
    """`evaluate`, and each episode's trajectory: lists of observation,
    action, reward, done and info per step."""
    trajectories = []
    stats = defaultdict(list)
    for _ in range(num_episodes):
        trajectory = defaultdict(list)
        obs, info = env.reset()
        done = False
        while not done:
            action = policy_fn(obs)
            next_obs, r, terminated, truncated, info = env.step(np.asarray(action))
            done = bool(terminated or truncated)
            trajectory["observation"].append(obs)
            trajectory["action"].append(action)
            trajectory["reward"].append(r)
            trajectory["done"].append(done)
            trajectory["info"].append(info)
            obs = next_obs
        _final_stats(stats, info)
        trajectories.append(dict(trajectory))
    return {k: float(np.mean(v)) for k, v in stats.items()}, trajectories


def bootstrap_std(arr, f=np.mean, n: int = 30,
                  indices: Optional[Sequence[np.ndarray]] = None) -> float:
    """The std of statistic `f` over `n` resamples of `arr` with
    replacement: `indices` (n arrays of len(arr) row indices), drawn from
    numpy's global state unless given, as the JAX function draws them."""
    arr = np.asarray(arr)
    if indices is None:
        indices = [np.random.choice(len(arr), len(arr)) for _ in range(n)]
    return float(np.std([f(arr[idx]) for idx in indices]))
