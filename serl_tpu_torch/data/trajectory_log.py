"""Trajectory logging to npz shards (TensorFlow-free), and loading them back.

Port of `serl_tpu/data/trajectory_log.py`: `TrajectoryLogger` appends
transitions, tags each with an RLDS-style step type (RESTART, TRANSITION,
TERMINATION, TRUNCATION) and writes every `max_episodes_per_file` episodes
as one compressed npz shard plus a JSON manifest; `load_trajectory_dataset`
reads the episodes back and `populate_from_trajectory_log` inserts them
into a data store (e.g. `data/host_buffer.py::ReplayBufferDataStore`,
whose `rlds_logger` hook takes a `TrajectoryLogger`). An episode's steps
are stacked leaf by leaf with the dict keys in sorted order at every level,
as the JAX package's tree map orders them, so that both packages write the
same bytes for the same transitions (at the same clock: the manifest and
the zip entries carry the time) and read each other's directories. Tensor
leaves are copied to the host.
"""

import json
import os
import time
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np
import torch


class StepType(IntEnum):
    RESTART = 0
    TRANSITION = 1
    TERMINATION = 2
    TRUNCATION = 3


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _stack(steps: List[Dict]) -> Dict:
    """The steps' leaves stacked, dict keys sorted at every level."""
    first = steps[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in steps]) for k in sorted(first)}
    return np.stack([_host(s) for s in steps])


class TrajectoryLogger:
    """Append transitions; episodes are flushed to npz shards."""

    def __init__(self, directory: str, max_episodes_per_file: int = 5):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.max_eps = max_episodes_per_file
        self._episodes: List[Dict] = []
        self._current: List[Dict] = []
        self._shard = 0
        self._manifest_path = os.path.join(directory, "manifest.json")
        self._manifest = {"shards": [], "created": time.time()}

    def log_transition(self, transition: Dict, step_type: Optional[int] = None):
        """Append one transition (a dict of arrays, numbers or tensors); the
        step type defaults to RESTART for an episode's first, TERMINATION
        where dones > 0.5, else TRANSITION. An episode ends at TERMINATION or
        TRUNCATION."""
        tr = dict(transition)
        if step_type is None:
            if not self._current:
                step_type = StepType.RESTART
            elif _host(tr.get("dones", 0)) > 0.5:
                step_type = StepType.TERMINATION
            else:
                step_type = StepType.TRANSITION
        tr["step_type"] = int(step_type)
        self._current.append(tr)
        if step_type in (StepType.TERMINATION, StepType.TRUNCATION):
            self._episodes.append(_stack(self._current))
            self._current = []
            if len(self._episodes) >= self.max_eps:
                self.flush()

    def flush(self):
        if not self._episodes:
            return
        path = os.path.join(self.directory, f"shard_{self._shard:05d}.npz")
        flat = {}
        for i, ep in enumerate(self._episodes):
            for k, v in _flatten(ep).items():
                flat[f"ep{i}/{k}"] = v
        np.savez_compressed(path, **flat)
        self._manifest["shards"].append(
            {"path": os.path.basename(path), "episodes": len(self._episodes)})
        with open(self._manifest_path, "w") as f:
            json.dump(self._manifest, f)
        self._episodes = []
        self._shard += 1

    def close(self):
        """The open episode, if any, as a TRUNCATION; then flush."""
        if self._current:
            self._current[-1]["step_type"] = int(StepType.TRUNCATION)
            self._episodes.append(_stack(self._current))
            self._current = []
        self.flush()


def _flatten(d, parent=""):
    out = {}
    for k, v in d.items():
        key = f"{parent}.{k}" if parent else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(d):
    out = {}
    for k, v in d.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def load_trajectory_dataset(directory: str) -> List[Dict]:
    """Episodes (dicts of stacked arrays) from a logged directory."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    episodes = []
    for shard in manifest["shards"]:
        data = np.load(os.path.join(directory, shard["path"]), allow_pickle=False)
        by_ep: Dict[int, Dict] = {}
        for key in data.files:
            ep_str, rest = key.split("/", 1)
            by_ep.setdefault(int(ep_str[2:]), {})[rest] = data[key]
        for i in sorted(by_ep):
            episodes.append(_unflatten(by_ep[i]))
    return episodes


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _row(tree, i: int):
    if isinstance(tree, dict):
        return {k: _row(tree[k], i) for k in sorted(tree)}
    return tree[i]


def populate_from_trajectory_log(store, directory: str) -> int:
    """Insert every logged transition (without its step type) into `store`,
    episode by episode; returns the count."""
    n = 0
    for ep in load_trajectory_dataset(directory):
        ep = dict(ep)
        ep.pop("step_type", None)
        for i in range(len(_first_leaf(ep))):
            store.insert(_row(ep, i))
            n += 1
    return n
