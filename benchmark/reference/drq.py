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

Precision, as a cell's configuration states it (`Precision`): products of
the MLPs, heads and bottlenecks in float32 with TF32 off; the small encoder's
convolutions in bfloat16 (inputs, weights and bias cast, relu in bfloat16,
then float32 pooling); the frozen ResNet-10 in float32 parameters with TF32
convolutions and float32 GroupNorm. The control lowers each part one step:
TF32 products, bfloat16 backbone convolutions, and float8 (e4m3, one scale
per tensor) inputs and weights of the small encoder's convolutions.

Work that the update would compute twice on the same parameters and inputs is
computed once: the frozen backbone's map of each cropped frame (one per
update, for every pass and the target), and in the actor update the encoder
up to its dropout, shared by the policy's pass and the critic's. The target
backbone equals the online one but for the rounding of the polyak average.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6  # flax LayerNorm
GN_EPS = 1e-5  # the ResNet's GroupNorm
GN_GROUPS = 4
DROPOUT_KEEP = 0.9
CROP_PADDING = 4
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STD_MIN, STD_MAX = 1e-5, 5.0
_F32 = np.float32


class Precision(NamedTuple):
    """tf32_products: the MLPs', heads' and bottlenecks' products in TF32.
    backbone: "tf32" or "bf16" convolutions of the frozen ResNet-10.
    small_convs: "bf16" or "fp8" convolutions of the small encoder."""

    tf32_products: bool = False
    backbone: str = "tf32"
    small_convs: str = "bf16"


STATED = Precision()
CONTROL = Precision(tf32_products=True, backbone="bf16", small_convs="fp8")


class Spec(NamedTuple):
    """The recipe's constants that the update reads."""

    encoder: str  # "small" or "resnet10"
    image_keys: tuple
    discount: float
    tau: float
    target_entropy: float
    ensemble: int
    subsample: int
    lr: Dict[str, float]  # group -> learning rate
    warmup: Dict[str, int]  # group -> warmup steps (0: none)


@contextlib.contextmanager
def products(prec: Precision):
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


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor; the
    gradient passes to x as it is, and the convolution's own gradients read
    the rounded values, as an fp8 convolution's would."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())


def small_encoder(img: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
                  prec: Precision) -> torch.Tensor:
    """SERL's SmallEncoder: 4 x (3x3 stride-2 VALID conv, relu) in bfloat16,
    then the spatial mean and the 256-wide bottleneck."""
    x = (img.to(torch.bfloat16) / 255.0).permute(0, 3, 1, 2)
    for i in range(4):
        w = p[f"{prefix}.convs.{i}.weight"].to(torch.bfloat16)
        b = p[f"{prefix}.convs.{i}.bias"].to(torch.bfloat16)
        if prec.small_convs == "fp8":
            x, w = _fp8(x), _fp8(w)
        x = F.relu(F.conv2d(x, w, b, stride=2))
    x = x.float().mean(dim=(-2, -1))
    return bottleneck(x, p, prefix)


def bottleneck(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    return dense_ln_tanh(x, p[f"{prefix}.bottleneck.dense.weight"].t(),
                         p[f"{prefix}.bottleneck.dense.bias"],
                         p[f"{prefix}.bottleneck.norm.weight"],
                         p[f"{prefix}.bottleneck.norm.bias"])


def _same(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int, prec: Precision) -> torch.Tensor:
    """flax "SAME" convolution (the odd pad after) in the backbone's precision."""
    top, bottom = _same(x.shape[-2], w.shape[-1], stride)
    left, right = _same(x.shape[-1], w.shape[-1], stride)
    x = F.pad(x, (left, right, top, bottom))
    if prec.backbone == "bf16":
        return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        return F.conv2d(x, w, stride=stride)


def resnet10_map(img: torch.Tensor, bb: Dict[str, torch.Tensor], prec: Precision) -> torch.Tensor:
    """The frozen ResNet-10 (stages 1-1-1-1, widths 64-512, GroupNorm(4)):
    (B, H, W, 3) uint8 -> the (B, 512, h, w) float32 map."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    x = ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    w = bb["conv_init"]
    if prec.backbone == "bf16":
        x = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=2, padding=3).float()
    else:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            x = F.conv2d(x, w, stride=2, padding=3)
    x = F.relu(F.group_norm(x, GN_GROUPS, bb["norm_init.scale"], bb["norm_init.bias"], GN_EPS))
    top, bottom = _same(x.shape[-2], 3, 2)
    left, right = _same(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
    for i in range(4):
        blk = f"block{i}"
        stride = 1 if i == 0 else 2
        y = _conv_same(x, bb[f"{blk}.conv0"], stride, prec)
        y = F.relu(F.group_norm(y, GN_GROUPS, bb[f"{blk}.gn0.scale"], bb[f"{blk}.gn0.bias"], GN_EPS))
        y = _conv_same(y, bb[f"{blk}.conv1"], 1, prec)
        y = F.group_norm(y, GN_GROUPS, bb[f"{blk}.gn1.scale"], bb[f"{blk}.gn1.bias"], GN_EPS)
        residual = x
        if f"{blk}.proj" in bb:
            residual = F.group_norm(_conv_same(x, bb[f"{blk}.proj"], stride, prec), GN_GROUPS,
                                    bb[f"{blk}.proj_norm.scale"], bb[f"{blk}.proj_norm.bias"],
                                    GN_EPS)
        x = F.relu(residual + y)
    return x


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
    dropout (the pooled features; None for the small encoder, which has
    none) or its features; and the proprio features."""

    pre_dropout: Dict[str, torch.Tensor]
    proprio: torch.Tensor


class Learner:
    """The reference learner's parameters, optimizer states and target."""

    def __init__(self, spec: Spec, params: Dict[str, torch.Tensor],
                 backbone: Optional[Dict[str, torch.Tensor]] = None):
        self.spec = spec
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.target = {k: v.clone() for k, v in self.params.items() if group_of(k) == "critic"}
        self.backbone = backbone
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = {"actor": 0, "critic": 0, "temperature": 0}

    # -- encoders

    def encode_start(self, obs: Dict, params: Dict[str, torch.Tensor], prec: Precision,
                     maps: Optional[Dict[str, torch.Tensor]] = None) -> Encoded:
        """The encoder up to each camera's dropout; `maps` are the frozen
        backbone's maps of these frames where the caller has them."""
        pre = {}
        for k in self.spec.image_keys:
            prefix = f"encoder.encoders.{k}"
            if self.spec.encoder == "small":
                pre[k] = small_encoder(obs[k], params, prefix, prec)
            else:
                fmap = maps[k] if maps is not None else resnet10_map(obs[k], self.backbone, prec)
                pre[k] = learned_embeddings(fmap, params, prefix)
        proprio = dense_ln_tanh(obs["state"], params["encoder.proprio.weight"].t(),
                                params["encoder.proprio.bias"],
                                params["encoder.proprio_norm.weight"],
                                params["encoder.proprio_norm.bias"])
        return Encoded(pre, proprio)

    def encode_finish(self, enc: Encoded, params: Dict[str, torch.Tensor],
                      masks: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
        """The rest of the encoder: dropout and bottleneck per camera, then
        the features of every camera and the proprio, concatenated."""
        feats = []
        for k in self.spec.image_keys:
            x = enc.pre_dropout[k]
            if self.spec.encoder != "small":
                if masks is not None:
                    x = dropout(x, masks[k])
                x = bottleneck(x, params, f"encoder.encoders.{k}")
            feats.append(x)
        return torch.cat(feats + [enc.proprio], -1)

    def maps(self, obs: Dict, prec: Precision) -> Optional[Dict[str, torch.Tensor]]:
        if self.spec.encoder == "small":
            return None
        with torch.no_grad():
            return {k: resnet10_map(obs[k], self.backbone, prec) for k in self.spec.image_keys}

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
                  prec: Precision) -> Dict[str, object]:
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
                             prec: Precision) -> Dict[str, object]:
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
                    prec: Precision = STATED) -> List[Dict[str, object]]:
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
def act(learner: Learner, obs: Dict, eps: torch.Tensor, prec: Precision = STATED) -> torch.Tensor:
    """The policy's actions for the envs' observations (images (N, 1, H, W, C))
    and standard-normal noise, without dropout."""
    obs = {**obs, **{k: obs[k][:, 0] for k in learner.spec.image_keys}}
    with products(prec):
        enc = learner.encode_start(obs, learner.params, prec)
        loc, scale = learner.policy(learner.encode_finish(enc, learner.params, None),
                                    learner.params)
    return torch.tanh(loc + scale * eps)
