"""Behaviour cloning.

Port of `serl_tpu/agents/bc.py`: `BCAgent`, a Gaussian policy (not
tanh-squashed by default) trained by the negative log-likelihood of the
demonstrated actions, with the mean squared error of its mode in the info;
`sample_actions` gives the mode (`argmax`) or a draw; `get_debug_metrics`.
One train-state group, "actor", with `make_optimizer(learning_rate)`.

With `image_keys` the policy reads an `ObsEncoder` over the DrQ registry's
encoders (`agents/drq.py::make_image_encoders`) and the proprio; the
encoder is never trained (its features are taken under no_grad, the JAX
package's stop_gradient, and it has no optimizer) and runs in train mode
in `update` (dropout keep-masks from `draws`), in eval mode when acting.
"resnet-pretrained" grafts the committed ResNet-10 into each camera's
backbone and raises without the file.

The policy is the port's PolicyNet: with `use_layer_norm=False` its MLP is
Dense -> activation, plain torch, and never K5 (which serves Dense ->
LayerNorm -> tanh only); the encoder's bottleneck and proprio run K5.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from serl_tpu_torch import resolve_device
from serl_tpu_torch.common.optimizers import make_optimizer
from serl_tpu_torch.common.train_state import TrainState
from serl_tpu_torch.networks.actor_critic import PolicyNet
from serl_tpu_torch.utils.pretrained import graft_resnet10
from serl_tpu_torch.vision.encoding import ObsEncoder


@dataclass(frozen=True)
class BCConfig:
    """The JAX package's (unused) BC config: the camera keys only."""

    image_keys: Tuple[str, ...] = ()


class BCAgent(nn.Module):
    def __init__(self, actor: PolicyNet, encoder: Optional[nn.Module] = None,
                 image_keys: Tuple[str, ...] = ()):
        super().__init__()
        self.actor = actor
        self.encoder = encoder
        self.image_keys = tuple(image_keys)
        self.state: Optional[TrainState] = None

    def _features(self, obs, train: bool = False, dropout: Optional[Dict] = None):
        if self.encoder is None:
            return obs
        with torch.no_grad():  # the encoder is never trained
            return self.encoder(obs, train=train, dropout=dropout)

    def forward_policy(self, obs, *, temperature: float = 1.0, train: bool = False,
                       dropout: Optional[Dict] = None):
        return self.actor(self._features(obs, train, dropout), temperature=temperature)

    def update(self, batch: Dict, draws: Optional[Dict] = None):
        """One NLL step on {"observations", "actions"}, in place; returns
        (self, {"actor_loss", "mse"}). With an encoder, it runs in train
        mode, with the keep-masks draws["encoder_dropout"] ({image key:
        mask}) where its pooling has dropout."""
        dropout = (draws or {}).get("encoder_dropout")

        def loss_fn():
            dist = self.forward_policy(batch["observations"], train=self.encoder is not None,
                                       dropout=dropout)
            log_probs = dist.log_prob(batch["actions"])
            mse = ((dist.mode() - batch["actions"]) ** 2).sum(-1)
            loss = -log_probs.mean()
            return loss, {"actor_loss": loss.detach(), "mse": mse.detach().mean()}

        info = self.state.apply_loss_fns({"actor": loss_fn})
        return self, info["actor"]

    @torch.no_grad()
    def sample_actions(self, observations, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None, temperature: float = 1.0,
                       argmax: bool = False) -> torch.Tensor:
        """The policy's mode with `argmax`, else a draw (standard-normal
        `noise` if given, from `generator` otherwise)."""
        dist = self.forward_policy(observations, temperature=temperature)
        if argmax:
            return dist.mode()
        return dist.sample(generator=generator, eps=noise)

    @torch.no_grad()
    def get_debug_metrics(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dist = self.forward_policy(batch["observations"])
        pi_actions = dist.mode()
        return {"mse": ((pi_actions - batch["actions"]) ** 2).sum(-1),
                "log_probs": dist.log_prob(batch["actions"]), "pi_actions": pi_actions}

    @classmethod
    def create(cls, observations, actions: torch.Tensor, *, encoder_type: str = "small",
               image_keys: Iterable[str] = (), use_proprio: bool = False,
               network_kwargs: Optional[dict] = None, policy_kwargs: Optional[dict] = None,
               learning_rate: float = 3e-4, generator: Optional[torch.Generator] = None,
               device=None) -> "BCAgent":
        """A BC agent for example batches `observations` ((B, obs_dim), or
        with `image_keys` a dict {"state": (B, S), "<key>": (B, T, H, W, C)
        uint8}) and `actions` (B, action_dim); weights from `generator` on
        the CPU (the encoder's first), then moved to `device` ("cuda" unless
        given). Defaults as the JAX package's: hidden (256, 256), swish, no
        LayerNorm, an "exp" std in [1e-5, 10], no tanh squash."""
        image_keys = tuple(image_keys)
        nk = network_kwargs or {"hidden_dims": (256, 256)}
        pk = policy_kwargs or {"tanh_squash_distribution": False}
        encoder = None
        features = observations.shape[-1] if not image_keys else None
        if image_keys:
            from serl_tpu_torch.agents import drq

            first = drq._images(observations)[image_keys[0]]
            in_channels = first.shape[-1] * (first.shape[-4] if first.dim() == 5 else 1)
            encoders = drq.make_image_encoders(encoder_type, image_keys,
                                               in_channels=in_channels,
                                               image_size=tuple(first.shape[-3:-1]),
                                               generator=generator)
            state = observations["state"]
            encoder = ObsEncoder(encoders, image_keys, state.shape[-1], use_proprio=use_proprio,
                                 enable_stacking=True, generator=generator)
            features = encoder.out_features
        actor = PolicyNet(
            features,
            actions.shape[-1],
            hidden_dims=tuple(nk.get("hidden_dims", (256, 256))),
            activations=nk.get("activations", "swish"),
            use_layer_norm=nk.get("use_layer_norm", False),
            std_parameterization=pk.get("std_parameterization", "exp"),
            std_min=pk.get("std_min", 1e-5),
            std_max=pk.get("std_max", 10.0),
            tanh_squash=pk.get("tanh_squash_distribution", False),
            fixed_std=pk.get("fixed_std"),
            generator=generator,
        )
        agent = cls(actor, encoder, image_keys).to(resolve_device(device))
        agent.state = TrainState(params={"actor": list(agent.actor.parameters())},
                                 txs={"actor": make_optimizer(learning_rate=learning_rate)})
        if encoder_type == "resnet-pretrained" and image_keys:
            graft_resnet10(agent.encoder, image_keys)
        return agent
