"""Behaviour cloning.

Port of `serl_tpu/agents/bc.py` without an encoder: `BCAgent` over flat
state observations, a Gaussian policy (not tanh-squashed by default) trained
by the negative log-likelihood of the demonstrated actions, with the mean
squared error of its mode in the info; `sample_actions` gives the mode
(`argmax`) or a draw; `get_debug_metrics`. One train-state group, "actor",
with `make_optimizer(learning_rate)`.

The policy is the port's PolicyNet: with `use_layer_norm=False` its MLP is
Dense -> activation, plain torch, and never K5 (which serves Dense ->
LayerNorm -> tanh only).

Not ported yet, and raising: BC through an image encoder (`image_keys`),
with its pretrained-ResNet graft; no example reaches it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

from serl_tpu_torch import resolve_device
from serl_tpu_torch.common.optimizers import make_optimizer
from serl_tpu_torch.common.train_state import TrainState
from serl_tpu_torch.networks.actor_critic import PolicyNet


class BCAgent(nn.Module):
    def __init__(self, actor: PolicyNet):
        super().__init__()
        self.actor = actor
        self.state: Optional[TrainState] = None

    def forward_policy(self, obs: torch.Tensor, *, temperature: float = 1.0):
        return self.actor(obs, temperature=temperature)

    def update(self, batch: Dict[str, torch.Tensor]):
        """One NLL step on {"observations", "actions"}, in place; returns
        (self, {"actor_loss", "mse"})."""

        def loss_fn():
            dist = self.forward_policy(batch["observations"])
            log_probs = dist.log_prob(batch["actions"])
            mse = ((dist.mode() - batch["actions"]) ** 2).sum(-1)
            loss = -log_probs.mean()
            return loss, {"actor_loss": loss.detach(), "mse": mse.detach().mean()}

        info = self.state.apply_loss_fns({"actor": loss_fn})
        return self, info["actor"]

    @torch.no_grad()
    def sample_actions(self, observations: torch.Tensor, *,
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
    def create(cls, observations: torch.Tensor, actions: torch.Tensor, *,
               image_keys: Iterable[str] = (), network_kwargs: Optional[dict] = None,
               policy_kwargs: Optional[dict] = None, learning_rate: float = 3e-4,
               generator: Optional[torch.Generator] = None, device=None) -> "BCAgent":
        """A BC agent for example batches `observations` (B, obs_dim) and
        `actions` (B, action_dim); weights from `generator` on the CPU, then
        moved to `device` ("cuda" unless given). Defaults as the JAX
        package's: hidden (256, 256), swish, no LayerNorm, an "exp" std in
        [1e-5, 10], no tanh squash."""
        if tuple(image_keys):
            raise NotImplementedError("BC with an image encoder is not ported yet")
        nk = network_kwargs or {"hidden_dims": (256, 256)}
        pk = policy_kwargs or {"tanh_squash_distribution": False}
        actor = PolicyNet(
            observations.shape[-1],
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
        agent = cls(actor).to(resolve_device(device))
        agent.state = TrainState(params={"actor": list(agent.actor.parameters())},
                                 txs={"actor": make_optimizer(learning_rate=learning_rate)})
        return agent
