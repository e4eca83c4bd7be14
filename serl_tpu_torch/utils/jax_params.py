"""Carry a SAC agent's parameters between the JAX package's layout and the port.

The JAX agent's params are a nested dict
    {"actor": {"MLP_0": {"Dense_i": {kernel, bias}, "LayerNorm_i": {scale, bias}},
               "Dense_0": means, "Dense_1": log-std head | "log_stds": (A,)},
     "critic": {"encoder": {} for state agents, for pixel agents
                    {"encoders_<key>": {"Conv_i": {kernel (3,3,in,out), bias},
                                        "Dense_0": bottleneck, "LayerNorm_0": {scale, bias}},
                     "Dense_0": proprio, "LayerNorm_0": proprio norm},
                "head": {"EnsembleMLP_0": {"EnsembleDense_i": {kernel (E,in,out), bias (E,out)},
                                           "LayerNorm_i": {scale, bias}},
                         "EnsembleDense_0": {kernel, bias}}},
     "temperature": {"raw": ()}}
whose leaves are numpy arrays here (this module never imports JAX). A ResNet
camera encoder carries flax's ResNet names instead of Conv_i (`resnet_pairs`):
"resnet" {"conv_init", "norm_init", "ResNetBlock_i", "SpatialLearnedEmbeddings_0",
"Dense_0", "LayerNorm_0"}, "resnet-pretrained" the same with the backbone
under "pretrained_encoder". Dense
kernels (in, out) become Linear weights (out, in); conv kernels (H, W, in,
out) become Conv2d weights (out, in, H, W); LayerNorm `scale` becomes
`weight`; ensemble kernels keep their (E, in, out) layout. These are the
names flax's `ObsEncoder.init` gives (`make_image_encoders` names each
camera's encoder after its key; one encoder shared by several keys sits
under the first key's name).

A goal-conditioned encoder's towers sit under "encoder" and "goal_encoder",
a language-conditioned one's under "encoder" (with FilmConditioning_i
{"Dense_0": add, "Dense_1": mult} after each block, and with
multiplicative conditioning Dense_i before the bottleneck's Dense, which
takes the next index); a frozen-backbone encoder's tree is its head alone
(the JAX module keeps the backbone's params in its closure; the port's
MobileNetV1 loads them with `MobileNetV1.load_params`), and a ResNet-50's
blocks are BottleneckResNetBlock_i with Conv_0..2.

A VICE agent's "vice" group is the VICEClassifier's tree ({"encoders_<key>",
"Dense_0", "LayerNorm_0", "Dense_1"}); a BinaryClassifier's is
{"encoder_def": <ObsEncoder tree>, "Dense_0", "LayerNorm_0", "Dense_1"}
(`classifier_pairs`), and a BC agent's actor the SAC actor's
(`actor_pairs`).

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
from serl_tpu_torch.vision.encoders import PreTrainedResNetEncoder, ResNetEncoder
from serl_tpu_torch.vision.encoding import GCObsEncoder, LCObsEncoder, ObsEncoder
from serl_tpu_torch.vision.mobilenet import FrozenBackboneEncoder


def _to_torch(value: torch.Tensor, layout) -> torch.Tensor:
    if layout == "T":
        return value.T
    if layout == "HWIO":
        return value.permute(3, 2, 0, 1)
    return value


def _to_jax(value: torch.Tensor, layout) -> torch.Tensor:
    if layout == "T":
        return value.T
    if layout == "HWIO":
        return value.permute(2, 3, 1, 0)
    return value


def _dense(path, layer):
    return [(path + ("kernel",), layer.weight, "T"), (path + ("bias",), layer.bias, None)]


def _norm(path, norm):
    return [(path + ("scale",), norm.weight, None), (path + ("bias",), norm.bias, None)]


def _head_pairs(prefix, enc, dense_index=0):
    """The pooling head's and the bottleneck's parameters of an encoder (the
    bottleneck is Dense_<dense_index> where Dense layers precede it)."""
    out = []
    pool = enc.pool
    if pool is not None and pool.embeddings is not None:
        out.append((prefix + ("SpatialLearnedEmbeddings_0", "kernel"), pool.embeddings.kernel,
                    None))
    softmax = None if pool is None else pool.softmax
    if softmax is not None and softmax.softmax_temperature is not None:
        out.append((prefix + ("SpatialSoftmax_0", "softmax_temperature"),
                    pool.softmax.softmax_temperature, None))
    if enc.bottleneck is not None:
        out += _dense(prefix + (f"Dense_{dense_index}",), enc.bottleneck.dense)
        out += _norm(prefix + ("LayerNorm_0",), enc.bottleneck.norm)
    return out


def resnet_pairs(enc, prefix=()):
    """(flax path, tensor, layout) of a `ResNetEncoder`'s parameters, under
    flax's names: conv_init, norm_init, ResNetBlock_i (or
    BottleneckResNetBlock_i) with Conv_j, GroupNorm_j (or LayerNorm_j),
    conv_proj, norm_proj; FilmConditioning_i and the multiplicative
    conditioning's Dense_i; then the pooling head and the bottleneck."""
    norm = "GroupNorm" if enc.norm_kind == "group" else "LayerNorm"
    out = [(prefix + ("conv_init", "kernel"), enc.conv_init.weight, "HWIO")]
    out += _norm(prefix + ("norm_init",), enc.norm_init)
    for i, block in enumerate(enc.blocks):
        bp = prefix + (f"{type(block).__name__}_{i}",)
        for j, (conv, nrm) in enumerate(zip(block.convs, block.norms)):
            out += [(bp + (f"Conv_{j}", "kernel"), conv.weight, "HWIO")]
            out += _norm(bp + (f"{norm}_{j}",), nrm)
        if block.conv_proj is not None:
            out += [(bp + ("conv_proj", "kernel"), block.conv_proj.weight, "HWIO")]
            out += _norm(bp + ("norm_proj",), block.norm_proj)
    for i, film in enumerate(enc.films or []):
        out += _dense(prefix + (f"FilmConditioning_{i}", "Dense_0"), film.add)
        out += _dense(prefix + (f"FilmConditioning_{i}", "Dense_1"), film.mult)
    n_cond = len(enc.cond_dense or [])
    for i, layer in enumerate(enc.cond_dense or []):
        out += _dense(prefix + (f"Dense_{i}",), layer)
    return out + _head_pairs(prefix, enc, dense_index=n_cond)


def _camera_pairs(prefix, enc):
    """One camera encoder's parameters: SmallEncoder, ResNetEncoder,
    PreTrainedResNetEncoder or FrozenBackboneEncoder (its head)."""
    if isinstance(enc, ResNetEncoder):
        return resnet_pairs(enc, prefix)
    if isinstance(enc, FrozenBackboneEncoder):
        return _head_pairs(prefix, enc)
    if isinstance(enc, PreTrainedResNetEncoder):
        return (resnet_pairs(enc.pretrained_encoder, prefix + ("pretrained_encoder",))
                + _head_pairs(prefix, enc))
    out = []
    for i, conv in enumerate(enc.convs):
        out += [(prefix + (f"Conv_{i}", "kernel"), conv.weight, "HWIO"),
                (prefix + (f"Conv_{i}", "bias"), conv.bias, None)]
    return out + _head_pairs(prefix, enc)


def _encoder_pairs(encoder, root=("critic", "encoder")):
    """(jax path, tensor, layout) of an agent's encoder: an ObsEncoder, a
    GCObsEncoder, an LCObsEncoder or one camera encoder alone."""
    if isinstance(encoder, GCObsEncoder):
        out = _camera_pairs(root + ("encoder",), encoder.encoder)
        if encoder.goal_encoder is not None:
            out += _camera_pairs(root + ("goal_encoder",), encoder.goal_encoder)
        return out
    if isinstance(encoder, LCObsEncoder):
        return _camera_pairs(root + ("encoder",), encoder.encoder)
    if not isinstance(encoder, ObsEncoder):
        return _camera_pairs(root, encoder)
    out, seen = [], set()
    for key in encoder.image_keys:
        enc = encoder.encoders[key]
        if id(enc) in seen:
            continue
        seen.add(id(enc))
        out += _camera_pairs(root + (f"encoders_{key}",), enc)
    if encoder.proprio is not None:
        out += _dense(root + ("Dense_0",), encoder.proprio)
        out += _norm(root + ("LayerNorm_0",), encoder.proprio_norm)
    return out


def actor_pairs(actor, root=("actor",)):
    """(flax path, tensor, layout) of a PolicyNet's parameters."""
    out = []
    for i, layer in enumerate(actor.trunk.dense):
        out += _dense(root + ("MLP_0", f"Dense_{i}"), layer)
    for i, norm in enumerate(actor.trunk.norms or []):
        out += _norm(root + ("MLP_0", f"LayerNorm_{i}"), norm)
    out += _dense(root + ("Dense_0",), actor.mean)
    if actor.std_head is not None:
        out += _dense(root + ("Dense_1",), actor.std_head)
    if actor.log_stds is not None:
        out += [(root + ("log_stds",), actor.log_stds, None)]
    return out


def _classifier_head_pairs(head, root=()):
    """The classifier head's Dense_0, LayerNorm_0 and Dense_1 (networks/classifier.py)."""
    return (_dense(root + ("Dense_0",), head.dense) + _norm(root + ("LayerNorm_0",), head.norm)
            + _dense(root + ("Dense_1",), head.out))


def classifier_pairs(classifier):
    """(flax path, tensor, layout) of a BinaryClassifier: its ObsEncoder under
    "encoder_def" (cameras as "encoders_<key>"), then the head."""
    return (_encoder_pairs(classifier.encoder_def, root=("encoder_def",))
            + _classifier_head_pairs(classifier.head))


def vice_pairs(vice, root=()):
    """(flax path, tensor, layout) of a VICEClassifier (agents/vice.py): each
    camera's encoder as "encoders_<key>", then the head."""
    out = []
    for key in vice.image_keys:
        out += _camera_pairs(root + (f"encoders_{key}",), vice.encoders[key])
    return out + _classifier_head_pairs(vice.head, root)


def mlp_pairs(mlp, root=()):
    """(flax path, tensor, layout) of an MLP: Dense_i, LayerNorm_i."""
    out = []
    for i, layer in enumerate(mlp.dense):
        out += _dense(root + (f"Dense_{i}",), layer)
    for i, norm in enumerate(mlp.norms or []):
        out += _norm(root + (f"LayerNorm_{i}",), norm)
    return out


def ensemble_mlp_pairs(mlp, root=()):
    """(flax path, tensor, layout) of an EnsembleMLP: EnsembleDense_i
    ((E, in, out) kernels as they are), LayerNorm_i."""
    out = []
    for i, layer in enumerate(mlp.dense):
        out += [(root + (f"EnsembleDense_{i}", "kernel"), layer.kernel, None),
                (root + (f"EnsembleDense_{i}", "bias"), layer.bias, None)]
    for i, norm in enumerate(mlp.norms or []):
        out += _norm(root + (f"LayerNorm_{i}",), norm)
    return out


def critic_family_pairs(net):
    """(flax path, tensor, layout) of a ValueCritic, DistributionalCriticNet,
    ContrastiveCritic or MLPResNet (networks/actor_critic.py, mlp.py)."""
    from serl_tpu_torch.networks.actor_critic import (ContrastiveCritic,
                                                      DistributionalCriticNet, ValueCritic)
    from serl_tpu_torch.networks.mlp import MLPResNet

    if isinstance(net, ValueCritic):
        return mlp_pairs(net.trunk, ("MLP_0",)) + _dense(("Dense_0",), net.value)
    if isinstance(net, DistributionalCriticNet):
        return (ensemble_mlp_pairs(net.trunk, ("EnsembleMLP_0",))
                + [(("EnsembleDense_0", "kernel"), net.logits.kernel, None),
                   (("EnsembleDense_0", "bias"), net.logits.bias, None)])
    if isinstance(net, ContrastiveCritic):
        out = []
        for name, tower in net.towers.items():
            out += mlp_pairs(tower["mlp"], (f"{name}_mlp",))
            out += _dense((f"{name}_proj",), tower["proj"])
        return out
    if isinstance(net, MLPResNet):
        out = _dense(("Dense_0",), net.inp)
        for i, block in enumerate(net.blocks):
            bp = (f"MLPResNetBlock_{i}",)
            out += _dense(bp + ("Dense_0",), block.up) + _dense(bp + ("Dense_1",), block.down)
            if block.proj is not None:
                out += _dense(bp + ("Dense_2",), block.proj)
            if block.norm is not None:
                out += _norm(bp + ("LayerNorm_0",), block.norm)
        return out + _dense(("Dense_1",), net.out)
    raise TypeError(f"no flax layout for {type(net).__name__}")


def pairs_to_tree(pairs) -> Dict:
    """The flax tree (numpy leaves) of `pairs`' tensors."""
    tree = {}
    for path, tensor, layout in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax(tensor.detach().cpu(), layout).numpy().copy()
    return tree


def _pairs(agent: SACAgent):
    """(jax path, torch tensor, layout) for every parameter; layout None
    (as it is), "T" (transposed) or "HWIO" (conv kernel). A VICE agent's
    "vice" group comes last."""
    out = actor_pairs(agent.actor)
    if agent.encoder is not None:
        out += _encoder_pairs(agent.encoder)
    head = ("critic", "head")
    critic = agent.critic
    for i, layer in enumerate(critic.trunk.dense):
        out += [(head + ("EnsembleMLP_0", f"EnsembleDense_{i}", "kernel"), layer.kernel, None),
                (head + ("EnsembleMLP_0", f"EnsembleDense_{i}", "bias"), layer.bias, None)]
    for i, norm in enumerate(critic.trunk.norms or []):
        out += _norm(head + ("EnsembleMLP_0", f"LayerNorm_{i}"), norm)
    out += [(head + ("EnsembleDense_0", "kernel"), critic.head.kernel, None),
            (head + ("EnsembleDense_0", "bias"), critic.head.bias, None)]
    out += [(("temperature", "raw"), agent.temperature_raw, None)]
    if getattr(agent, "vice", None) is not None:
        out += vice_pairs(agent.vice, ("vice",))
    return out


def load_pairs(pairs, tree: Dict):
    """Copy the leaves of the flax tree `tree` (numpy) into the tensors of
    `pairs` ((path, tensor, layout), e.g. from `resnet_pairs`), in place."""
    with torch.no_grad():
        for path, tensor, layout in pairs:
            node = tree
            for key in path:
                node = node[key]
            value = _to_torch(torch.from_numpy(np.array(node, np.float32)), layout)
            if value.shape != tensor.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)}, "
                                 f"port expects {tuple(tensor.shape)}")
            tensor.copy_(value)


def load_encoder_params(encoder, tree: Dict):
    """Copy flax `ObsEncoder` params `tree` (numpy leaves) into the port's
    ObsEncoder `encoder` (in place)."""
    load_pairs(_encoder_pairs(encoder, root=()), tree)
    return encoder


def load_sac_params(agent: SACAgent, params_np: Dict) -> SACAgent:
    """Copy the JAX-layout params `params_np` into `agent` (in place)."""
    if params_np["critic"].get("encoder") and agent.encoder is None:
        raise ValueError("state agents have no encoder params")
    load_pairs(_pairs(agent), params_np)
    return agent


def to_jax_layout(agent: SACAgent) -> Dict:
    """The inverse of `load_sac_params`: the agent's params as the JAX
    package's nested dict of numpy arrays."""
    tree = pairs_to_tree(_pairs(agent))
    tree["critic"].setdefault("encoder", {})
    return tree



def _group_pairs(agent: SACAgent, group: str):
    """(jax path within the group, index in the group's tensor list,
    layout) for every parameter of a train-state group."""
    params = agent.state.params[group]
    return [(path[1:], next(i for i, p in enumerate(params) if p is tensor), layout)
            for path, tensor, layout in _pairs(agent) if path[0] == group]


def group_tree(agent: SACAgent, group: str, tensors) -> Dict:
    """A list of tensors aligned with `agent.state.params[group]` (params,
    grads, targets, Adam moments) as the JAX package's tree for that group."""
    tree = {"encoder": {}} if group == "critic" else {}
    for path, i, layout in _group_pairs(agent, group):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax(tensors[i].detach().cpu(), layout).numpy().copy()
    return tree


def _load_group(agent: SACAgent, group: str, tree: Dict, tensors) -> None:
    with torch.no_grad():
        for path, i, layout in _group_pairs(agent, group):
            node = tree
            for key in path:
                node = node[key]
            value = _to_torch(torch.from_numpy(np.array(node, np.float32)), layout)
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
