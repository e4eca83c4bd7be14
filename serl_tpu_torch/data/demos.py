"""Demonstration collection and ingestion.

Port of `serl_tpu/data/demos.py`: roll a (scripted or learned) policy out
over N lockstep envs and return a flat transitions dict, keep the
successful episodes, save and load them, and turn them into a write-once
demo ring for RLPD's `sample_mixed`. The pickle holds numpy arrays, so a
demo file written by the JAX package loads here, and the reverse.
Observations are the flat state vector, or with `pixel_obs=True` the SERL
pixel dict {"state": (7,), "<camera>": (H, W, 3) uint8} (`serl_obs`), each
frame rendered by the env (K2) and kept on its device: nothing here copies
a frame to the host. The env is the pick env or a pose task
(`envs/tasks.py`), with its action width. `collect_state_bank` records the
states a policy visits, the pose tasks' demo reset bank.
"""

import pickle
from typing import Callable, Dict

import numpy as np
import torch

from serl_tpu_torch.envs.panda_pick import EnvState, PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.wrappers import serl_obs


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def collect_episodes(env: PandaPickCubeEnv, policy_fn: Callable, generator: torch.Generator,
                     num_episodes: int, episode_len: int = 100, pixel_obs: bool = False,
                     auto_reset: bool = False) -> Dict[str, torch.Tensor]:
    """Roll out `num_episodes` lockstep envs for `episode_len` steps;
    returns a transitions dict of (num_episodes * episode_len, ...) tensors
    on the env's device, stream-major (each env's steps contiguous), with
    `success` and `ep_ids`. `policy_fn(states, generator) -> (N, action_dim)`
    actions.

    `auto_reset=False`: one fixed-length episode per stream, ep_ids the
    stream index. `auto_reset=True`: ended episodes are replaced by fresh
    ones within the stream, whose rows carry ep_id * num_episodes + stream,
    and next_observations is the pre-reset observation. `pixel_obs=True`
    (an env with `image_obs`): observations in `serl_obs`' layout."""
    to_obs = serl_obs if pixel_obs else flatten_obs
    states, obs = env.reset(num_episodes, generator)
    streams = torch.arange(num_episodes, dtype=torch.int32, device=env.device)
    steps = []
    for _ in range(episode_len):
        actions = policy_fn(states, generator)
        if auto_reset:
            new_states, next_obs, rew, done, info = env.step_auto_reset(states, actions,
                                                                         generator=generator)
            stored_next = to_obs(info["final_obs"])
            row_ep = states.ep_id * num_episodes + streams
        else:
            new_states, next_obs, rew, done, info = env.step(states, actions)
            stored_next = to_obs(next_obs)
            row_ep = streams
        steps.append({
            "observations": to_obs(obs),
            "actions": actions,
            "next_observations": stored_next,
            "rewards": rew,
            "masks": 1.0 - done,
            "dones": done,
            "success": info["success"],
            "ep_ids": row_ep,
        })
        states, obs = new_states, next_obs
    # (T, N, ...) -> (N * T, ...), stream-major
    out = _map_steps(lambda xs: torch.stack(xs, 1).flatten(0, 1), steps)
    if not auto_reset:
        out["ep_ids"] = streams.repeat_interleave(episode_len)
    return out


@torch.no_grad()
def collect_state_bank(env, policy_fn: Callable, generator: torch.Generator,
                       num_streams: int = 8, steps: int = 100) -> EnvState:
    """Roll `policy_fn(states, generator)` out over `num_streams` lockstep
    envs with auto-reset for `steps` steps and return every PRE-step state,
    stacked time-major along a leading bank axis of num_streams * steps
    (the input of `PandaPoseTaskEnv.set_demo_reset_bank`)."""
    states, _ = env.reset(num_streams, generator)
    bank = []
    for _ in range(steps):
        actions = policy_fn(states, generator)
        bank.append(states)
        states = env.step_auto_reset(states, actions, generator=generator, final_obs=False)[0]
    cat = lambda xs: torch.cat(xs, 0)
    return EnvState(engine.PhysicsState(*map(cat, zip(*(s.physics for s in bank)))),
                    *(cat([getattr(s, f) for s in bank]) for f in ("t", "z_init", "ep_id")))


def _map_steps(fn, steps):
    """fn over the list of each leaf's per-step values, for nested dicts."""
    if isinstance(steps[0], dict):
        return {k: _map_steps(fn, [s[k] for s in steps]) for k in steps[0]}
    return fn(steps)


def _tensors(transitions: Dict) -> Dict:
    return _map(torch.as_tensor, transitions)


def filter_successful(transitions: Dict, episode_len: int = 100) -> Dict:
    """Keep only the episodes whose largest success flag is 1, renumbered
    0, 1, ...; leaves are tensors (numpy arrays are taken too)."""
    t = _tensors(transitions)
    keep = t["success"].reshape(-1, episode_len).amax(1) > 0.5
    rows = keep.repeat_interleave(episode_len)
    out = _map(lambda v: v[rows], t)
    out["ep_ids"] = torch.arange(int(keep.sum()), dtype=torch.int32,
                                 device=rows.device).repeat_interleave(episode_len)
    return out


def take_transitions(transitions: Dict, n: int) -> Dict:
    """The first n transitions of a (possibly nested) transitions dict."""
    return _map(lambda v: v[:n], transitions)


def select_demo_episodes(transitions: Dict, num_episodes: int, episode_len: int = 100) -> Dict:
    """The first `num_episodes` successful episodes, in their order, then
    unsuccessful ones if there are not enough, renumbered 0, 1, ...; no
    copy to the host."""
    t = _tensors(transitions)
    succ = t["success"].reshape(-1, episode_len).amax(1)
    order = torch.argsort(1.0 - succ, stable=True)[:num_episodes]
    idx = (order[:, None] * episode_len
           + torch.arange(episode_len, device=order.device)[None, :]).reshape(-1)
    out = _map(lambda v: v[idx], t)
    out["ep_ids"] = torch.arange(num_episodes, dtype=torch.int32,
                                 device=order.device).repeat_interleave(episode_len)
    return out


def save_demos(transitions: Dict, path: str) -> None:
    """Pickle the transitions as numpy arrays (the JAX package's format)."""
    with open(path, "wb") as f:
        pickle.dump(_map(lambda v: torch.as_tensor(v).cpu().numpy(), transitions), f)


def load_demos(path: str) -> Dict[str, np.ndarray]:
    """A demo pickle of numpy arrays, from this package or the JAX one.
    Unpickling runs code: load only files this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def demos_to_buffer(rb, transitions: Dict, episode_len: int = 100):
    """A fresh, full, write-once buffer state on `rb`'s device: each demo
    episode becomes one stream."""
    tr = dict(transitions)
    tr.pop("success", None)
    ep_ids = tr.pop("ep_ids")
    return rb.init_from_episodes(tr, ep_ids, episode_len)
