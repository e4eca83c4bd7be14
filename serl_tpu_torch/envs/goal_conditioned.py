"""Goal-conditioned environment layer, trajectory loading, a dm_env adapter.

Port of `serl_tpu/envs/goal_conditioned.py`. The JAX layer is a single-env
function that the loop vmaps, drawing each env's goal from a key it keeps in
its state. Here the layer wraps the port's batched envs (`envs/panda_pick.py`
and its kin) and steps all N envs at once, and the goal draws are explicit
(N,) tensors: the goal-bank indices (int64), or for a callable sampler the
draws it takes (uniforms on [0, 1) unless the caller gives others). They
come from the caller (`goal_draws=`) or from the `torch.Generator`, at
reset and at every `step_auto_reset`, where they are used only for the envs
whose episode ended; all N are drawn every step, so no host sync on `done`.

Observations are {"observation": obs, "goal": goal}. With a `reward_fn`
the reward is recomputed from the goal: in `step_auto_reset` an ended
env's reward comes from its terminal observation (info["final_obs"])
against the goal of the episode that ended, and info["final_obs"] pairs
that observation with that (old) goal; the returned observation of an
ended env is its new episode's first, paired with the freshly drawn goal.

`load_trajectory_dataset` and `DMEnvAdapter` are host code over numpy,
as in the JAX package (no TFRecord, no dm_env import).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch


class GCState(NamedTuple):
    """Carry of a goal-conditioned env: the inner env's state and the (N, ...) goals."""

    inner: Any
    goal: Any


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


class GoalConditionedEnv:
    """The goal-conditioned layer over a batched env. `goal_sampler` is a goal
    bank (a tree of tensors with a leading bank axis; env n's goal is entry
    draws[n]) or a callable `(draws, obs) -> goals` (the affordance-model
    path), given the (N,) draws and the observations the goal is for."""

    def __init__(self, env, goal_sampler: Union[Any, Callable],
                 reward_fn: Optional[Callable] = None):
        self.env = env
        self.reward_fn = reward_fn
        self.goal_sampler = goal_sampler
        if not callable(goal_sampler):
            device = getattr(env, "device", None)
            self.goal_sampler = _tree_map(
                lambda x: torch.as_tensor(x, dtype=torch.float32, device=device), goal_sampler)

    @property
    def time_limit_steps(self) -> int:
        return self.env.time_limit_steps

    def sample_goal_draws(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """(num_envs,) bank indices, uniform over the bank, or uniforms on
        [0, 1) for a callable sampler."""
        device = getattr(self.env, "device", None)
        if callable(self.goal_sampler):
            return torch.rand((num_envs,), generator=generator, device=device)
        n = _first_leaf(self.goal_sampler).shape[0]
        return torch.randint(0, n, (num_envs,), generator=generator, device=device)

    def goals(self, draws: torch.Tensor, obs):
        if callable(self.goal_sampler):
            return self.goal_sampler(draws, obs)
        idx = draws.to(_first_leaf(self.goal_sampler).device, torch.int64)
        return _tree_map(lambda x: x[idx], self.goal_sampler)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              goal_draws: Optional[torch.Tensor] = None, **inner_kwargs):
        inner, obs = self.env.reset(num_envs, generator, **inner_kwargs)
        if goal_draws is None:
            goal_draws = self.sample_goal_draws(num_envs, generator)
        goal = self.goals(goal_draws, obs)
        return GCState(inner, goal), {"observation": obs, "goal": goal}

    def step(self, state: GCState, action: torch.Tensor):
        inner, obs, reward, done, info = self.env.step(state.inner, action)
        if self.reward_fn is not None:
            reward = self.reward_fn(obs, state.goal)
        return (GCState(inner, state.goal), {"observation": obs, "goal": state.goal}, reward,
                done, info)

    def step_auto_reset(self, state: GCState, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        goal_draws: Optional[torch.Tensor] = None, **inner_kwargs):
        """Step; an ended env resets (inner env) and takes a new goal. The
        inner env's reset draws come first from `generator`, then the goals'."""
        inner, obs, reward, done, info = self.env.step_auto_reset(
            state.inner, action, generator=generator, final_obs=True, **inner_kwargs)
        is_done = done > 0.5
        if self.reward_fn is not None:
            reward = torch.where(is_done, self.reward_fn(info["final_obs"], state.goal),
                                 self.reward_fn(obs, state.goal))
        if goal_draws is None:
            goal_draws = self.sample_goal_draws(action.shape[0], generator)
        fresh = self.goals(goal_draws, obs)
        goal = _tree_map(
            lambda new, old: torch.where(is_done.view((-1,) + (1,) * (old.dim() - 1)), new, old),
            fresh, state.goal)
        info = dict(info)
        info["final_obs"] = {"observation": info["final_obs"], "goal": state.goal}
        return GCState(inner, goal), {"observation": obs, "goal": goal}, reward, done, info


def goal_distance_reward(key: str, threshold: float = 0.05, sparse: bool = True,
                         goal_key: Optional[str] = None) -> Callable:
    """Per-env goal-reaching reward on one observation key: 1.0 where the
    distance to the goal is below `threshold` (`sparse`), else -distance.
    `key` may be a `/`-joined path into the observation dict (e.g.
    "state/block_pos"); `goal_key` defaults to the path's last part."""

    def lookup(d, path):
        for part in path.split("/"):
            d = d[part]
        return d

    gkey = goal_key if goal_key is not None else key.split("/")[-1]

    def fn(obs: Dict, goal: Dict) -> torch.Tensor:
        diff = lookup(obs, key) - lookup(goal, gkey)
        d = torch.sqrt((diff.reshape(diff.shape[0], -1) ** 2).sum(-1))
        return (d < threshold).to(torch.float32) if sparse else -d

    return fn


def make_gc_env(env, goal_sampler, reward_fn: Optional[Callable] = None) -> GoalConditionedEnv:
    """The JAX package's factory: time limits live in the env, chunking and
    normalisation in envs/wrappers.py, video in utils/video.py, so it is the
    goal-conditioned layer itself."""
    return GoalConditionedEnv(env, goal_sampler, reward_fn)


# ---------------------------------------------------------------- trajectories


def load_trajectory_dataset(data_path: str):
    """Yield the trajectories of a directory's `*.npz` and `*.pkl` files, in
    sorted order, as nested dicts of numpy arrays. An npz file's `/`-joined
    flat keys become nested dicts; a key that is both a leaf and a prefix
    raises ValueError. A pickle holds one trajectory or a list of them."""
    paths = sorted(glob.glob(os.path.join(data_path, "*.npz"))
                   + glob.glob(os.path.join(data_path, "*.pkl")))
    for p in paths:
        if p.endswith(".npz"):
            flat = dict(np.load(p, allow_pickle=False))
            traj: Dict[str, Any] = {}
            for k, v in flat.items():
                parts = k.split("/")
                d = traj
                for part in parts[:-1]:
                    nxt = d.setdefault(part, {})
                    if not isinstance(nxt, dict):
                        raise ValueError(
                            f"{p}: key '{k}' nests under '{part}', which is already a leaf "
                            "array — flat npz keys must not be both a leaf and a prefix")
                    d = nxt
                if isinstance(d.get(parts[-1]), dict):
                    raise ValueError(f"{p}: key '{k}' is a leaf but also a prefix of other keys")
                d[parts[-1]] = v
            yield traj
        else:
            with open(p, "rb") as f:
                data = pickle.load(f)
            if isinstance(data, list):
                yield from data
            else:
                yield data


# ---------------------------------------------------------------- dm_env


class DMEnvAdapter:
    """A dm_env-style environment behind the gym API, duck-typed (no dm_env
    import): the wrapped object has `reset() -> timestep` and `step(action)
    -> timestep`, a timestep `.observation`, `.reward`, `.discount` and
    `.last()`. A last step with discount 0 terminates, any other last step
    truncates; actions are clipped to [action_low, action_high]."""

    def __init__(self, dm_environment, action_low=-1.0, action_high=1.0):
        self._env = dm_environment
        self.action_low = action_low
        self.action_high = action_high

    def reset(self, *, seed: Optional[int] = None, options=None):
        ts = self._env.reset()
        return ts.observation, {}

    def step(self, action):
        action = np.clip(action, self.action_low, self.action_high)
        ts = self._env.step(action)
        terminated = bool(ts.last()) and (ts.discount == 0.0)
        truncated = bool(ts.last()) and not terminated
        reward = 0.0 if ts.reward is None else float(ts.reward)
        return ts.observation, reward, terminated, truncated, {}

    def render(self):
        if hasattr(self._env, "physics"):
            return self._env.physics.render()
        return None
