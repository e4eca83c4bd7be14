"""Carry a SAC agent's parameters between the JAX package's layout and the port.

The JAX agent's params are a nested dict
    {"actor": {"MLP_0": {"Dense_i": {kernel, bias}, "LayerNorm_i": {scale, bias}},
               "Dense_0": means, "Dense_1": log-std head | "log_stds": (A,)},
     "critic": {"encoder": {},
                "head": {"EnsembleMLP_0": {"EnsembleDense_i": {kernel (E,in,out), bias (E,out)},
                                           "LayerNorm_i": {scale, bias}},
                         "EnsembleDense_0": {kernel, bias}}},
     "temperature": {"raw": ()}}
whose leaves are numpy arrays here (this module never imports JAX). Dense
kernels (in, out) become Linear weights (out, in); LayerNorm `scale` becomes
`weight`; ensemble kernels keep their (E, in, out) layout.

`load_train_state` / `train_state_to_jax_layout` carry the whole learner
state: params, the target critic and each group's optimizer state, as
    {"params": <tree above>, "target_params": {"critic": <critic tree>},
     "step": int,
     "opt_states": {group: {"mu": <group tree>, "nu": <group tree>,
                            "count": int, "learning_rate": float}}}
where `count` stands for all three of optax's counts (Adam's, the lr
schedule's and inject_hyperparams'), which agree, and `learning_rate` is the
hyperparameter that `optimizer_lr` reads.
"""

from typing import Dict

import numpy as np
import torch

from serl_tpu_torch.agents.sac import SACAgent


def _pairs(agent: SACAgent):
    """(jax path, torch tensor, transpose?) for every parameter."""
    out = []
    actor = agent.actor
    for i, layer in enumerate(actor.trunk.dense):
        out += [(("actor", "MLP_0", f"Dense_{i}", "kernel"), layer.weight, True),
                (("actor", "MLP_0", f"Dense_{i}", "bias"), layer.bias, False)]
    for i, norm in enumerate(actor.trunk.norms or []):
        out += [(("actor", "MLP_0", f"LayerNorm_{i}", "scale"), norm.weight, False),
                (("actor", "MLP_0", f"LayerNorm_{i}", "bias"), norm.bias, False)]
    out += [(("actor", "Dense_0", "kernel"), actor.mean.weight, True),
            (("actor", "Dense_0", "bias"), actor.mean.bias, False)]
    if actor.std_head is not None:
        out += [(("actor", "Dense_1", "kernel"), actor.std_head.weight, True),
                (("actor", "Dense_1", "bias"), actor.std_head.bias, False)]
    if actor.log_stds is not None:
        out += [(("actor", "log_stds"), actor.log_stds, False)]
    head = ("critic", "head")
    critic = agent.critic
    for i, layer in enumerate(critic.trunk.dense):
        out += [(head + ("EnsembleMLP_0", f"EnsembleDense_{i}", "kernel"), layer.kernel, False),
                (head + ("EnsembleMLP_0", f"EnsembleDense_{i}", "bias"), layer.bias, False)]
    for i, norm in enumerate(critic.trunk.norms or []):
        out += [(head + ("EnsembleMLP_0", f"LayerNorm_{i}", "scale"), norm.weight, False),
                (head + ("EnsembleMLP_0", f"LayerNorm_{i}", "bias"), norm.bias, False)]
    out += [(head + ("EnsembleDense_0", "kernel"), critic.head.kernel, False),
            (head + ("EnsembleDense_0", "bias"), critic.head.bias, False)]
    out += [(("temperature", "raw"), agent.temperature_raw, False)]
    return out


def load_sac_params(agent: SACAgent, params_np: Dict) -> SACAgent:
    """Copy the JAX-layout params `params_np` into `agent` (in place)."""
    if params_np["critic"].get("encoder"):
        raise ValueError("state agents have no encoder params")
    with torch.no_grad():
        for path, tensor, transpose in _pairs(agent):
            node = params_np
            for key in path:
                node = node[key]
            value = torch.as_tensor(np.asarray(node, np.float32))
            value = value.T if transpose else value
            if value.shape != tensor.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)}, "
                                 f"port expects {tuple(tensor.shape)}")
            tensor.copy_(value)
    return agent


def to_jax_layout(agent: SACAgent) -> Dict:
    """The inverse of `load_sac_params`: the agent's params as the JAX
    package's nested dict of numpy arrays."""
    tree = {"critic": {"encoder": {}}}
    for path, tensor, transpose in _pairs(agent):
        value = tensor.detach().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (value.T if transpose else value).numpy().copy()
    return tree



def _group_pairs(agent: SACAgent, group: str):
    """(jax path within the group, index in the group's tensor list,
    transpose?) for every parameter of a train-state group."""
    params = agent.state.params[group]
    return [(path[1:], next(i for i, p in enumerate(params) if p is tensor), transpose)
            for path, tensor, transpose in _pairs(agent) if path[0] == group]


def group_tree(agent: SACAgent, group: str, tensors) -> Dict:
    """A list of tensors aligned with `agent.state.params[group]` (params,
    grads, targets, Adam moments) as the JAX package's tree for that group."""
    tree = {"encoder": {}} if group == "critic" else {}
    for path, i, transpose in _group_pairs(agent, group):
        value = tensors[i].detach().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (value.T if transpose else value).numpy().copy()
    return tree


def _load_group(agent: SACAgent, group: str, tree: Dict, tensors) -> None:
    with torch.no_grad():
        for path, i, transpose in _group_pairs(agent, group):
            node = tree
            for key in path:
                node = node[key]
            value = torch.as_tensor(np.asarray(node, np.float32))
            value = value.T if transpose else value
            if value.shape != tensors[i].shape:
                raise ValueError(f"{group}/{'/'.join(path)}: shape {tuple(value.shape)}, "
                                 f"port expects {tuple(tensors[i].shape)}")
            tensors[i].copy_(value)


def load_train_state(agent: SACAgent, state_np: Dict) -> SACAgent:
    """Copy a whole JAX-layout learner state (see the module docstring) into
    `agent` and its train state (in place)."""
    load_sac_params(agent, state_np["params"])
    state = agent.state
    for group, targets in state.target_params.items():
        _load_group(agent, group, state_np["target_params"][group], targets)
    for group, opt in state.opt_states.items():
        src = state_np["opt_states"][group]
        _load_group(agent, group, src["mu"], opt.mu)
        _load_group(agent, group, src["nu"], opt.nu)
        opt.count = int(src["count"])
        opt.learning_rate = float(src["learning_rate"])
    state.step = int(state_np["step"])
    return agent


def train_state_to_jax_layout(agent: SACAgent) -> Dict:
    """The inverse of `load_train_state`."""
    state = agent.state
    return {
        "params": to_jax_layout(agent),
        "target_params": {g: group_tree(agent, g, t) for g, t in state.target_params.items()},
        "step": state.step,
        "opt_states": {g: {"mu": group_tree(agent, g, o.mu), "nu": group_tree(agent, g, o.nu),
                           "count": o.count, "learning_rate": o.learning_rate}
                       for g, o in state.opt_states.items()},
    }
