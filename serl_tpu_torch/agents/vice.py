"""VICE: DrQ with a learned, GAN-style goal classifier as the reward.

Port of `serl_tpu/agents/vice.py`. `VICEClassifier` is one encoder per
camera (each camera's frame stack folded into channels), the features
concatenated in `image_keys` order, then the classifier head of
networks/classifier.py (Dense 256 -> Dropout(0.1) -> LayerNorm(1e-6) ->
relu -> Dense 1). It is its own train-state group, "vice", with its own
optimizer (`make_optimizer(learning_rate=3e-4)`); every SAC update steps it
with zero gradients, and `update_vice` steps only it, every other group with
zero gradients, so Adam's moments and counts advance in every group at
every update, as in the JAX package.

`update_vice` trains the classifier on a batch whose next_observations hold
policy frames in the first half and goal frames in the second: BCE on
features mixed up in the encoded space, labels smoothed to 0.9 / 0.1, plus
10 x a gradient penalty at points between the two halves' features. The
penalty differentiates the head's summed logits with respect to those
points with `create_graph=True` and its loss then differentiates through
that gradient: a double backward through Linear, LayerNorm and relu, all
plain torch ops.

The JAX package's quirks, ported as they are:
  * the features are encoded outside the loss, so no gradient reaches the
    VICE encoders (they move only by Adam's zero-gradient steps);
  * one `eps` draw serves every camera's interpolation;
  * the penalty's norm adds 1e-6 per element inside the square root;
  * labels are smoothed to 0.9 / 0.1;
  * the batch's first half is policy frames, its second goal frames, and the
    loss puts the goals first.

Draws are explicit: `vice_draws` makes them (crop offsets, the mixup weight
`lam` (JAX's Beta(1, 1), a uniform), the permutation, the penalty's `eps`,
and the head's two dropout masks, (n, 256) for the mixed pass and (n/2, 256)
for the penalty pass), and the tests feed the JAX package's. `update_critics` is DrQ's
critic-only update on the classifier's rewards.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

from serl_tpu_torch.agents.drq import CROP_PADDING, DrQAgent, make_image_encoders
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.common.optimizers import make_optimizer
from serl_tpu_torch.common.train_state import TrainState
from serl_tpu_torch.networks.classifier import (
    ClassifierHead,
    dropout_mask,
    sigmoid_binary_cross_entropy,
)
from serl_tpu_torch.vision.augmentations import crop_offsets
from serl_tpu_torch.vision.encoding import fold_stack

GRADIENT_PENALTY_WEIGHT = 10.0


class VICEClassifier(nn.Module):
    """Per-camera encoders + classifier head -> logit; `return_encoded`
    gives {key: features}, `classify_encoded` runs the head on them."""

    def __init__(self, encoders: Dict[str, nn.Module], image_keys: Iterable[str],
                 hidden_dim: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_keys = tuple(image_keys)
        self.encoders = nn.ModuleDict({k: encoders[k] for k in self.image_keys})
        features = sum(self.encoders[k].out_features for k in self.image_keys)
        self.head = ClassifierHead(features, hidden_dim, generator)

    def forward(self, obs: Dict, train: bool = False, return_encoded: bool = False,
                classify_encoded: bool = False, dropout: Optional[torch.Tensor] = None,
                encoder_dropout: Optional[Dict[str, torch.Tensor]] = None):
        if classify_encoded:
            feats = {k: obs[k] for k in self.image_keys}
        else:
            imgs = obs.get("images", obs)
            encoder_dropout = encoder_dropout or {}
            feats = {k: self.encoders[k](fold_stack(imgs[k]), train=train,
                                         dropout=encoder_dropout.get(k))
                     for k in self.image_keys}
        if return_encoded:
            return feats
        x = torch.cat([feats[k] for k in self.image_keys], -1)
        return self.head(x, train, dropout)


class VICEAgent(DrQAgent):
    vice: VICEClassifier  # set by create_vice

    def forward_vice(self, obs: Dict, *, train: bool = True, **kwargs):
        return self.vice(obs, train=train, **kwargs)

    @torch.no_grad()
    def vice_reward(self, observation: Dict) -> torch.Tensor:
        """sigmoid of the classifier's logit, eval mode."""
        return torch.sigmoid(self.forward_vice(observation, train=False))

    def loss_fns(self, batch, draws):
        fns = super().loss_fns(batch, draws)
        fns["vice"] = None  # a zero loss: Adam steps with zero gradients
        return fns

    # ------------------------------------------------------------------ #

    def vice_draws(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict:
        """The draws of one `update_vice` of `batch`."""
        obs = batch["next_observations"]
        keys = self.config.vice_image_keys
        device = self.temperature_raw.device
        b = obs[keys[0]].shape[0]
        n = 2 * (2 * (b // 2))
        hidden = self.vice.head.dense.out_features
        enc_shapes = {k: (n, self.vice.encoders[k].dropout_features) for k in keys
                      if getattr(self.vice.encoders[k], "dropout_features", 0)}
        return {
            "augment": {k: crop_offsets(b * (obs[k].shape[1] if obs[k].dim() == 5 else 1),
                                        CROP_PADDING, generator, device)
                        for k in self.config.image_keys},
            "encoder_dropout": {k: dropout_mask(*s, generator, device)
                                for k, s in enc_shapes.items()},
            "lam": torch.rand((), generator=generator, device=device),
            "perm": torch.randperm(n, generator=generator, device=device),
            "eps": torch.rand((n // 2, 1), generator=generator, device=device),
            "dropout": dropout_mask(n, hidden, generator, device),
            "gp_dropout": dropout_mask(n // 2, hidden, generator, device),
        }

    def update_vice(self, batch: Dict, draws: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None):
        """BCE + mixup + label smoothing + gradient penalty on the classifier,
        in place; `batch["next_observations"]`' second half must be goal
        frames. Returns (self, info by group: info["vice"] holds "bce_loss"
        and "grad_norm")."""
        if draws is None:
            draws = self.vice_draws(batch, generator)
        observations = batch["next_observations"]
        aug_obs = self.data_augmentation_fn(observations, draws["augment"])
        keys = self.config.vice_image_keys
        obs_all = {}
        for k in keys:
            px, apx = observations[k], aug_obs[k]
            b = px.shape[0]
            obs_px = torch.cat([px[: b // 2], apx[: b // 2]], 0)
            goal_px = torch.cat([px[b // 2:], apx[b // 2:]], 0)
            obs_all[k] = torch.cat([goal_px, obs_px], 0)
        bsz = 2 * (observations[keys[0]].shape[0] // 2)
        device = self.temperature_raw.device
        labels = torch.cat([torch.ones(bsz, device=device), torch.zeros(bsz, device=device)])
        labels = labels * 0.8 + 0.1  # label smoothing
        with torch.no_grad():  # encoded outside the loss: no gradient to the encoders
            encoded = self.forward_vice(obs_all, return_encoded=True,
                                        encoder_dropout=draws.get("encoder_dropout"))
        lam = draws["lam"].to(device)
        perm = draws["perm"].to(device)
        n = labels.shape[0]
        mixed = {k: lam * v + (1 - lam) * v[perm] for k, v in encoded.items()}
        y_a, y_b = labels, labels[perm]
        eps = draws["eps"].to(device)
        gp = {k: eps * v[: n // 2] + (1 - eps) * v[n // 2:] for k, v in mixed.items()}
        info = {}

        def vice_loss():
            y_hat = self.forward_vice(mixed, classify_encoded=True, dropout=draws["dropout"])
            bce = (lam * sigmoid_binary_cross_entropy(y_hat, y_a).mean()
                   + (1 - lam) * sigmoid_binary_cross_entropy(y_hat, y_b).mean())
            points = {k: v.detach().requires_grad_(True) for k, v in gp.items()}
            logits = self.forward_vice(points, classify_encoded=True,
                                       dropout=draws["gp_dropout"])
            grads = torch.autograd.grad(logits.sum(), [points[k] for k in keys],
                                        create_graph=True)
            flat = torch.cat([g.reshape(g.shape[0], -1) for g in grads], -1)
            grad_norms = torch.sqrt(torch.sum(flat ** 2 + 1e-6, -1))
            grad_penalty = torch.mean((grad_norms - 1.0) ** 2)
            info.update(bce_loss=bce.detach(), grad_norm=grad_norms.detach().mean())
            return bce + GRADIENT_PENALTY_WEIGHT * grad_penalty, info

        loss_fns = {g: None for g in self.state.txs}
        loss_fns["vice"] = vice_loss
        infos = self.state.apply_loss_fns(loss_fns)
        return self, infos

    def _vice_rewards_for(self, next_obs: Dict) -> torch.Tensor:
        return (self.vice_reward(next_obs) >= 0.5).to(torch.float32)

    def update_high_utd(self, batch: Dict, *, utd_ratio: int, draws: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None):
        """Crop once, replace the rewards by the classifier's
        sigmoid >= 0.5 on the cropped next_observations, then SAC's
        `update_high_utd`; returns (self, info) with info["vice_rewards"]."""
        if draws is None:
            draws = self.drq_draws(batch, utd_ratio, generator)
        batch = dict(self._augment_batch(batch, draws["augment"]))
        rewards = self._vice_rewards_for(batch["next_observations"])
        batch["rewards"] = rewards
        _, info = SACAgent.update_high_utd(self, batch, utd_ratio=utd_ratio,
                                           draws=draws["updates"])
        info["vice_rewards"] = rewards.mean()
        return self, info

    def update_critics(self, batch: Dict, *, draws: Optional[Dict] = None,
                       generator: Optional[torch.Generator] = None):
        """DrQ's critic-only update with the rewards replaced by the
        classifier's sigmoid >= 0.5 on the cropped next_observations;
        `draws` as `critic_draws`."""
        if draws is None:
            draws = self.critic_draws(batch, generator)
        batch = dict(self._augment_batch(batch, draws["augment"]))
        batch["rewards"] = self._vice_rewards_for(batch["next_observations"])
        return self._critic_update(batch, draws["update"])

    # ------------------------------------------------------------------ #

    @classmethod
    def create_vice(
        cls,
        observations: Dict,
        actions: torch.Tensor,
        vice_observations: Optional[Dict] = None,
        *,
        encoder_type: str = "small",
        use_proprio: bool = True,
        image_keys: Iterable[str] = ("image",),
        vice_image_keys: Iterable[str] = ("image",),
        vice_optimizer_kwargs: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ) -> "VICEAgent":
        """A DrQ agent (`DrQAgent.create_drq` with these arguments and
        kwargs) with a VICE classifier over `vice_image_keys`, whose encoders
        are the registry's; its weights are drawn from `generator` after the
        DrQ agent's."""
        vice_observations = vice_observations if vice_observations is not None else observations
        agent = cls.create_drq(observations, actions, encoder_type=encoder_type,
                               use_proprio=use_proprio, image_keys=tuple(image_keys),
                               generator=generator, device=device, **kwargs)
        vice_image_keys = tuple(vice_image_keys)
        first = vice_observations.get("images", vice_observations)[vice_image_keys[0]]
        in_channels = first.shape[-1] * (first.shape[-4] if first.dim() == 5 else 1)
        encoders = make_image_encoders(encoder_type, vice_image_keys, in_channels=in_channels,
                                       image_size=tuple(first.shape[-3:-1]), generator=generator)
        agent.vice = VICEClassifier(encoders, vice_image_keys, generator=generator).to(
            agent.temperature_raw.device)
        kw = vice_optimizer_kwargs or {"learning_rate": 3e-4}
        state = agent.state
        agent.state = TrainState(
            params={**state.params, "vice": list(agent.vice.parameters())},
            txs={**state.txs, "vice": make_optimizer(**kw)},
            target_groups=("critic",),
        )
        agent.config = agent.config._replace(vice_image_keys=vice_image_keys)
        return agent
