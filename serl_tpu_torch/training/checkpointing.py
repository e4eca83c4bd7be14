"""Checkpoint / resume: a run's whole state, or its agent's params.

Port of `serl_tpu/training/checkpointing.py`, with `torch.save` where the
JAX package uses orbax. A tree (dicts, lists, NamedTuples, dataclasses, the
agent and its train state) is flattened to one {path: leaf} dict, the path
in `jax.tree_util.keystr`'s form (".field", "['key']", "[i]") with "/"
escaped as "|" as the JAX package does; a leaf is a tensor, a Python int or
float, or a `torch.Generator` (its `get_state()`). Each step is one file,
`<directory>/<step>/checkpoint.pt`, written under a temporary name and
renamed into place, so a reader never sees half a checkpoint. As orbax's
manager does, `save` skips a step at or below the latest one and keeps the
newest `keep` steps.

`restore(target=...)` puts the leaves back into the target's structure: a
tensor onto the target's device and dtype (an `nn.Parameter` in place, so
the agent's modules and optimizers keep their tensors), a generator's state
set, a leaf the checkpoint lacks left as the target's. The full loop carry
(training/loop.py::LoopCarry) goes in whole: the agent's params, target
params, Adam moments and host step counts, env states, both replay rings
with their host cursors, the generator and the counters. A run resumed from
it continues bit for bit.
"""

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch
from torch import nn

from serl_tpu_torch.common.train_state import TrainState

FILE = "checkpoint.pt"
_STATE_FIELDS = ("step", "params", "target_params", "opt_states")  # TrainState's


def _key(path: str) -> str:
    # a "/" in a dict key (obs keys such as "panda/tcp_pos") is escaped, as in the JAX package
    return path.replace("/", "|")


def _fields(x):
    """(field names, in place) for the structures flattened by attribute:
    the agent (its train state only), its TrainState (set in place), and
    dataclasses and NamedTuples (rebuilt); None for anything else."""
    if isinstance(x, nn.Module):
        return (("state",), True) if isinstance(getattr(x, "state", None), TrainState) else None
    if isinstance(x, TrainState):
        return _STATE_FIELDS, True
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(f.name for f in dataclasses.fields(x)), False
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return x._fields, False
    return None


def flatten(tree: Any, path: str = "", out: Optional[Dict] = None) -> Dict[str, Any]:
    """{keystr path: tensor (detached, on the CPU) | int | float | generator
    state} of every leaf of `tree`; None and other objects are left out."""
    out = {} if out is None else out
    fields = _fields(tree)
    if fields is not None:
        for name in fields[0]:
            flatten(getattr(tree, name), f"{path}.{name}", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(v, f"{path}[{i}]", out)
    elif isinstance(tree, torch.Tensor):
        out[_key(path)] = tree.detach().cpu().clone()
    elif isinstance(tree, torch.Generator):
        out[_key(path)] = tree.get_state()
    elif isinstance(tree, (bool, int, float)):
        out[_key(path)] = tree
    return out


@torch.no_grad()
def graft(target: Any, flat: Dict[str, Any], path: str = "") -> Any:
    """`target` with each leaf that `flat` holds (by path) put back; see the
    module docstring."""
    fields = _fields(target)
    if fields is not None:
        names, in_place = fields
        values = {name: graft(getattr(target, name), flat, f"{path}.{name}") for name in names}
        if in_place:
            for name, value in values.items():
                setattr(target, name, value)
            return target
        if isinstance(target, tuple):
            return target._replace(**values)
        return dataclasses.replace(target, **values)
    if isinstance(target, dict):
        return {k: graft(v, flat, f"{path}[{k!r}]") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(graft(v, flat, f"{path}[{i}]") for i, v in enumerate(target))
    key = _key(path)
    if key not in flat:
        return target
    value = flat[key]
    if isinstance(target, torch.Tensor):
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {tuple(value.shape)}, the target "
                             f"{tuple(target.shape)}")
        value = value.to(device=target.device, dtype=target.dtype)
        if isinstance(target, nn.Parameter):
            target.copy_(value)
            return target
        return value.contiguous()
    if isinstance(target, torch.Generator):
        target.set_state(value)
        return target
    if isinstance(target, (bool, int, float)):
        return type(target)(value)
    return target


class CheckpointManager:
    """Numbered checkpoints under `directory`, the newest `keep` kept."""

    def __init__(self, directory: str, keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, wait: bool = False) -> bool:
        """Write `tree` as step `step`; False (nothing written) when a step
        at or above it exists. The write is synchronous, so `wait` (the
        JAX package's flag for orbax's async save) changes nothing."""
        step = int(step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(flatten(tree), os.path.join(tmp, FILE))
            os.replace(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """Step `step` (default the latest) grafted onto `target`, or the
        flat dict itself without one; FileNotFoundError if it is absent."""
        step = self.latest_step() if step is None else int(step)
        path = None if step is None else os.path.join(self.directory, str(step), FILE)
        if path is None or not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {'found' if step is None else step} under "
                                    f"{self.directory}")
        flat = torch.load(path, map_location="cpu", weights_only=True)
        return flat if target is None else graft(target, flat)

    def close(self) -> None:
        """Nothing is pending (saves are synchronous); kept for the JAX API."""


def save_agent_checkpoint(path: str, agent, step: int, keep: int = 20) -> None:
    """The agent's params and target params as step `step` under `path`."""
    CheckpointManager(path, keep=keep).save(
        step, {**agent.state.params, "_target": agent.state.target_params})


def restore_agent_params(path: str, agent, step: Optional[int] = None):
    """The agent with its params (in place) and target params restored from
    `save_agent_checkpoint`'s step `step` (default the latest)."""
    tree = {**agent.state.params, "_target": agent.state.target_params}
    restored = CheckpointManager(path).restore(step, target=tree)
    agent.state.target_params = restored.pop("_target")
    agent.state.params = restored
    return agent
