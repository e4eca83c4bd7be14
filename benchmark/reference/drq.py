"""The plain reference of one DrQ learner: its networks, losses, Adam and target update.

Written from SERL's recipe (`serl_launcher/agents/continuous/drq.py` over
`sac.py`, with the JAX package's optax semantics) in plain PyTorch. It
imports torch and numpy only, and keeps its parameters in a dict keyed by the
port's parameter names, which is the only thing it shares with the program:
the benchmark makes every trained tensor from the seed and hands the same
values to both sides.

One `update_high_utd` is `utd` critic updates on contiguous minibatches of
the cropped batch, then one actor and temperature update on the whole batch.
Every update steps all three groups (a group without a loss steps with zero
gradients, so Adam's momentum still moves it) and, when the critic learns,
moves the target critic by polyak averaging. The optimizers are optax's Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root) behind a linear warmup
whose first step has learning rate 0; per-step scalars are float32.

What depends on the configuration is its own file, `reference/<config>.py`,
which the benchmark finds by the configuration's name (`manifest.reference`)
and hands to `Learner` as its `Encoder(config, device)`: each camera's
encoder from the uint8 frame to the input of its dropout, in plain torch
with autograd, so that a trained backbone gets its gradients; what follows
the dropout (`finish`); a frozen part's map, where the configuration has
one (`frozen_map`, else None); and what it loads (the frozen ResNet-10's
pickle, or nothing). Its `STATED` precision is the configuration's and its
`CONTROL` one step below, each a NamedTuple with `tf32_products` (the
MLPs', heads' and bottlenecks' float32 products in TF32 or not) and the
encoder's own fields; everything here is shared by every configuration.

Work that the update would compute twice on the same parameters and inputs is
computed once: a frozen part's map of each cropped frame (one per update,
for every pass and the target), and in the actor update the encoder up to
its dropout, shared by the policy's pass and the critic's. A frozen part of
the target equals the online one but for the rounding of the polyak average.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6  # flax LayerNorm
DROPOUT_KEEP = 0.9
CROP_PADDING = 4
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
STD_MIN, STD_MAX = 1e-5, 5.0
_F32 = np.float32


class Spec(NamedTuple):
    """The recipe's constants that the update reads."""

    image_keys: tuple
    discount: float
    tau: float
    target_entropy: float
    ensemble: int
    subsample: int
    lr: Dict[str, float]  # group -> learning rate
    warmup: Dict[str, int]  # group -> warmup steps (0: none)


@contextlib.contextmanager
def products(prec):
    """The float32 products (matmul, einsum) in TF32 or not, as `prec` says."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32_products
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def group_of(name: str) -> str:
    if name.startswith("actor."):
        return "actor"
    if name == "temperature_raw":
        return "temperature"
    return "critic"


# ------------------------------------------------------------------ layers


def dense_ln_tanh(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """tanh(LayerNorm(x W + b)), W as given ((K, D) or batched (E, K, D))."""
    h = torch.matmul(x, w) + b
    return torch.tanh(F.layer_norm(h, (h.shape[-1],), g, beta, LN_EPS))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x W^T + b for nn.Linear's (D, K) weight."""
    return torch.matmul(x, w.t()) + b


def bottleneck(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    return dense_ln_tanh(x, p[f"{prefix}.bottleneck.dense.weight"].t(),
                         p[f"{prefix}.bottleneck.dense.bias"],
                         p[f"{prefix}.bottleneck.norm.weight"],
                         p[f"{prefix}.bottleneck.norm.bias"])


def learned_embeddings(fmap: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """SpatialLearnedEmbeddings: (B, c, h, w) -> (B, c * 8)."""
    return torch.einsum("bchw,hwcf->bcf", fmap, p[f"{prefix}.pool.embeddings.kernel"]).flatten(1)


def dropout(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x / DROPOUT_KEEP, torch.zeros_like(x))


def crop(img: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """DrQ's random shift: pad 4 by repeating the edge, then the (H, W)
    window at each row's (dy, dx) in [0, 8]. img (B, H, W, C)."""
    b, h, w, _ = img.shape
    rows = torch.clamp(torch.arange(h, device=img.device)[None] + offsets[:, :1] - CROP_PADDING,
                       0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device)[None] + offsets[:, 1:] - CROP_PADDING,
                       0, w - 1)
    idx = torch.arange(b, device=img.device)[:, None, None]
    return img[idx, rows[:, :, None], cols[:, None, :]]


# ------------------------------------------------------------------ encoders and heads


class Encoded(NamedTuple):
    """An observation batch seen by one encoder: per camera, the input of its
    dropout (or its features, where it has none); and the proprio features."""

    pre_dropout: Dict[str, torch.Tensor]
    proprio: torch.Tensor


class Learner:
    """The reference learner's parameters, optimizer states and target."""

    def __init__(self, spec: Spec, params: Dict[str, torch.Tensor], encoder):
        self.spec = spec
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.target = {k: v.clone() for k, v in self.params.items() if group_of(k) == "critic"}
        self.encoder = encoder  # the configuration's `reference/<config>.py` Encoder
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = {"actor": 0, "critic": 0, "temperature": 0}

    # -- encoders

    def encode_start(self, obs: Dict, params: Dict[str, torch.Tensor], prec,
                     maps: Optional[Dict[str, torch.Tensor]] = None) -> Encoded:
        """The encoder up to each camera's dropout; `maps` are the frozen
        part's maps of these frames where the caller has them."""
        pre = {k: self.encoder.start(obs[k], params, f"encoder.encoders.{k}", prec,
                                     None if maps is None else maps[k])
               for k in self.spec.image_keys}
        proprio = dense_ln_tanh(obs["state"], params["encoder.proprio.weight"].t(),
                                params["encoder.proprio.bias"],
                                params["encoder.proprio_norm.weight"],
                                params["encoder.proprio_norm.bias"])
        return Encoded(pre, proprio)

    def encode_finish(self, enc: Encoded, params: Dict[str, torch.Tensor],
                      masks: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The rest of the encoder per camera (its dropout and what follows),
        then the features of every camera and the proprio, concatenated."""
        feats = [self.encoder.finish(enc.pre_dropout[k], params, f"encoder.encoders.{k}",
                                     None if masks is None else masks[k])
                 for k in self.spec.image_keys]
        return torch.cat(feats + [enc.proprio], -1)

    def maps(self, obs: Dict, prec) -> Optional[Dict[str, torch.Tensor]]:
        """The frozen part's maps of every camera's frames, or None where
        the configuration has no frozen part."""
        if self.encoder.frozen_map is None:
            return None
        with torch.no_grad():
            return {k: self.encoder.frozen_map(obs[k], prec) for k in self.spec.image_keys}

    # -- heads

    @staticmethod
    def policy(feats: torch.Tensor, p: Dict[str, torch.Tensor]):
        """(loc, scale) of the tanh-squashed Gaussian."""
        x = feats
        for i in range(2):
            x = dense_ln_tanh(x, p[f"actor.trunk.dense.{i}.weight"].t(),
                              p[f"actor.trunk.dense.{i}.bias"], p[f"actor.trunk.norms.{i}.weight"],
                              p[f"actor.trunk.norms.{i}.bias"])
        loc = linear(x, p["actor.mean.weight"], p["actor.mean.bias"])
        scale = torch.exp(linear(x, p["actor.std_head.weight"], p["actor.std_head.bias"]))
        return loc, torch.clamp(scale, STD_MIN, STD_MAX)

    @staticmethod
    def critic(feats: torch.Tensor, actions: torch.Tensor, p: Dict[str, torch.Tensor]):
        """(E, B) Q-values of the ensemble (one LayerNorm shared by the members)."""
        x = torch.cat([feats, actions], -1)
        for i in range(2):
            x = dense_ln_tanh(x, p[f"critic.trunk.dense.{i}.kernel"],
                              p[f"critic.trunk.dense.{i}.bias"][:, None, :],
                              p[f"critic.trunk.norms.{i}.weight"], p[f"critic.trunk.norms.{i}.bias"])
        q = torch.bmm(x, p["critic.head.kernel"]) + p["critic.head.bias"][:, None, :]
        return q.squeeze(-1)

    # -- losses


def sample_and_log_prob(loc: torch.Tensor, scale: torch.Tensor, eps: torch.Tensor):
    """A tanh-squashed Gaussian sample from standard-normal `eps`, and its log-density."""
    pre = loc + scale * eps
    z = (pre - loc) / scale
    base = (-0.5 * (z * z + math.log(2 * math.pi)) - torch.log(scale)).sum(-1)
    log_det = (2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))).sum(-1)
    return torch.tanh(pre), base - log_det


def _schedule(lr: float, warmup: int, count: int) -> float:
    lr32, c = _F32(lr), _F32(count)
    if warmup > 0:
        return float(lr32 * min(c / _F32(warmup), _F32(1)))
    return float(lr32)


def _adam(learner: Learner, group: str, grads: Optional[Dict[str, torch.Tensor]]) -> None:
    spec = learner.spec
    names = [k for k in learner.params if group_of(k) == group]
    count = learner.count[group] + 1
    bc1 = float(_F32(1) - _F32(B1) ** _F32(count))
    bc2 = float(_F32(1) - _F32(B2) ** _F32(count))
    lr = _schedule(spec.lr[group], spec.warmup[group], learner.count[group])
    with torch.no_grad():
        for k in names:
            mu, nu = learner.mu[k], learner.nu[k]
            mu.mul_(B1)
            nu.mul_(B2)
            if grads is not None and grads.get(k) is not None:
                mu.add_(grads[k], alpha=1.0 - B1)
                nu.addcmul_(grads[k], grads[k], value=1.0 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            learner.params[k].add_(update, alpha=-lr)
    learner.count[group] = count


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor], names: List[str]):
    leaves = [params[k] for k in names]
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(names, gs)}


def _trainable(learner: Learner, group: str) -> Dict[str, torch.Tensor]:
    return {k: (v.detach().requires_grad_(True) if group_of(k) == group else v)
            for k, v in learner.params.items()}


def critic_update(learner: Learner, batch: Dict, draws: Dict, maps_obs, maps_next,
                  prec) -> Dict[str, object]:
    """One critic update of a minibatch (the actor and temperature step with
    zero gradients): returns the loss and the critic group's gradients."""
    spec = learner.spec
    p = learner.params
    with torch.no_grad():
        enc_next = learner.encode_start(batch["next_observations"], p, prec, maps_next)
        feats = learner.encode_finish(enc_next, p, draws.get("critic_next_dropout"))
        loc, scale = learner.policy(feats, p)
        next_actions, _ = sample_and_log_prob(loc, scale, draws["critic_next_eps"])
        tp = {**p, **learner.target}
        tenc = learner.encode_start(batch["next_observations"], tp, prec, maps_next)
        tq = learner.critic(learner.encode_finish(tenc, tp, draws.get("target_dropout")),
                            next_actions, tp)
        tq = tq[draws["subsample_idx"]].min(0).values
        target_q = batch["rewards"] + spec.discount * batch["masks"] * tq
    cp = _trainable(learner, "critic")
    enc = learner.encode_start(batch["observations"], cp, prec, maps_obs)
    q = learner.critic(learner.encode_finish(enc, cp, draws.get("critic_dropout")),
                       batch["actions"], cp)
    loss = ((q - target_q[None]) ** 2).mean()
    names = [k for k in p if group_of(k) == "critic"]
    grads = _grads(loss, cp, names)
    _adam(learner, "actor", None)
    _adam(learner, "critic", grads)
    _adam(learner, "temperature", None)
    with torch.no_grad():
        for k, t in learner.target.items():
            t.mul_(1.0 - spec.tau).add_(p[k], alpha=spec.tau)
    return {"critic_loss": loss.detach(), "grads": grads}


def actor_temperature_update(learner: Learner, batch: Dict, draws: Dict, maps_obs, maps_next,
                             prec) -> Dict[str, object]:
    """The actor and temperature update of the whole batch (the critic
    steps with zero gradients, its target stays)."""
    spec = learner.spec
    p = learner.params
    alpha = F.softplus(p["temperature_raw"]).detach()
    with torch.no_grad():
        enc = learner.encode_start(batch["observations"], p, prec, maps_obs)
        feats_actor = learner.encode_finish(enc, p, draws.get("actor_dropout"))
        feats_critic = learner.encode_finish(enc, p, draws.get("actor_critic_dropout"))
    ap = _trainable(learner, "actor")
    loc, scale = learner.policy(feats_actor, ap)
    actions, log_probs = sample_and_log_prob(loc, scale, draws["actor_eps"])
    q = learner.critic(feats_critic, actions, p).mean(0)
    actor_loss = -(q - alpha * log_probs).mean()
    actor_names = [k for k in p if group_of(k) == "actor"]
    actor_grads = _grads(actor_loss, ap, actor_names)
    with torch.no_grad():
        enc_next = learner.encode_start(batch["next_observations"], p, prec, maps_next)
        nf = learner.encode_finish(enc_next, p, draws.get("temperature_next_dropout"))
        nloc, nscale = learner.policy(nf, p)
        _, next_log_probs = sample_and_log_prob(nloc, nscale, draws["temperature_next_eps"])
        entropy = -next_log_probs.mean()
    raw = p["temperature_raw"].detach().requires_grad_(True)
    temperature_loss = F.softplus(raw) * (entropy - spec.target_entropy)
    (traw,) = torch.autograd.grad(temperature_loss, [raw])
    _adam(learner, "actor", actor_grads)
    _adam(learner, "critic", None)
    _adam(learner, "temperature", {"temperature_raw": traw})
    with torch.no_grad():  # the size of each loss's terms, which may cancel in its mean
        scales = {"actor_loss": (q - alpha * log_probs).abs().mean(),
                  "temperature_loss": F.softplus(raw) * (entropy.abs() + abs(spec.target_entropy))}
    return {"actor_loss": actor_loss.detach(), "temperature_loss": temperature_loss.detach(),
            "scales": scales, "grads": {**actor_grads, "temperature_raw": traw}}


def augment(batch: Dict, offsets: Dict, image_keys) -> Dict:
    """Crop every camera of observations and next_observations; images
    arrive as (B, 1, H, W, C) stacks and leave as (B, H, W, C)."""
    out = dict(batch)
    for part in ("observations", "next_observations"):
        obs = dict(batch[part])
        for k in image_keys:
            obs[k] = crop(obs[k][:, 0], offsets[part][k])
        out[part] = obs
    return out


def _rows(tree, rows: slice):
    if isinstance(tree, dict):
        return {k: _rows(v, rows) for k, v in tree.items()}
    return tree[rows]


def update_high_utd(learner: Learner, batch: Dict, draws: Dict, utd: int,
                    prec) -> List[Dict[str, object]]:
    """One DrQ `update_high_utd`: the crop, `utd` critic updates, then the
    actor and temperature update; returns each update's losses and grads."""
    with products(prec):
        return _update_high_utd(learner, batch, draws, utd, prec)


def _update_high_utd(learner, batch, draws, utd, prec):
    batch = augment(batch, draws["augment"], learner.spec.image_keys)
    maps_obs = learner.maps(batch["observations"], prec)
    maps_next = learner.maps(batch["next_observations"], prec)
    rows = batch["rewards"].shape[0] // utd
    out = []
    for i in range(utd):
        cut = slice(i * rows, (i + 1) * rows)
        out.append(critic_update(learner, _rows(batch, cut), draws["updates"][i],
                                 None if maps_obs is None else _rows(maps_obs, cut),
                                 None if maps_next is None else _rows(maps_next, cut), prec))
    out.append(actor_temperature_update(learner, batch, draws["updates"][utd], maps_obs,
                                        maps_next, prec))
    return out


@torch.no_grad()
def act(learner: Learner, obs: Dict, eps: torch.Tensor, prec) -> torch.Tensor:
    """The policy's actions for the envs' observations (images (N, 1, H, W, C))
    and standard-normal noise, without dropout."""
    obs = {**obs, **{k: obs[k][:, 0] for k in learner.spec.image_keys}}
    with products(prec):
        enc = learner.encode_start(obs, learner.params, prec)
        loc, scale = learner.policy(learner.encode_finish(enc, learner.params, None),
                                    learner.params)
    return torch.tanh(loc + scale * eps)
