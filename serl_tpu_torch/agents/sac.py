"""Soft Actor-Critic: the acting part.

Port of the forward passes, `sample_actions` and `create_states` of
`serl_tpu/agents/sac.py`. The agent holds the same three parameter groups
as the JAX package: "actor" (PolicyNet), "critic" (the ensemble CriticNet;
its "encoder" group is empty for state observations) and "temperature" (one
softplus-parameterized scalar). The losses, `update` and `update_high_utd`,
and the target critic they use, belong to the learner and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from serl_tpu_torch import resolve_device
from serl_tpu_torch.networks.actor_critic import CriticNet, PolicyNet
from serl_tpu_torch.networks.lagrange import init_lagrange_params, lagrange_value


class SACConfig(NamedTuple):
    """Static agent configuration: the JAX package's SACConfig for state
    agents (its image-key and encoder fields wait for the pixel agents)."""

    discount: float = 0.95
    target_entropy: float = 0.0
    backup_entropy: bool = False
    critic_ensemble_size: int = 2
    critic_subsample_size: Optional[int] = None


class SACAgent(nn.Module):
    def __init__(self, actor: PolicyNet, critic: CriticNet, temperature_init: float,
                 config: SACConfig):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.temperature_raw = nn.Parameter(init_lagrange_params(temperature_init)["raw"])
        self.config = config

    # ------------------------------------------------------------------ #
    # Forward passes
    # ------------------------------------------------------------------ #

    def forward_policy(self, obs: torch.Tensor, *, temperature: float = 1.0):
        return self.actor(obs, temperature=temperature)

    def forward_critic(self, obs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return self.critic(obs, actions)

    def temperature(self) -> torch.Tensor:
        return lagrange_value({"raw": self.temperature_raw})

    @torch.no_grad()
    def sample_actions(
        self,
        observations: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        argmax: bool = False,
        temperature: float = 1.0,
    ) -> torch.Tensor:
        """Actions for a batch of observations: the distribution's mode when
        `argmax`, else a sample with standard-normal `noise` if given, drawn
        from `generator` otherwise."""
        dist = self.forward_policy(observations, temperature=temperature)
        if argmax:
            return dist.mode()
        return dist.sample(generator=generator, eps=noise)

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def create_states(
        cls,
        observations: torch.Tensor,
        actions: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        critic_network_kwargs: dict = {"hidden_dims": (256, 256)},
        policy_network_kwargs: dict = {"hidden_dims": (256, 256)},
        policy_kwargs: dict = {
            "tanh_squash_distribution": True,
            "std_parameterization": "uniform",
        },
        critic_ensemble_size: int = 2,
        critic_subsample_size: Optional[int] = None,
        temperature_init: float = 1.0,
        discount: float = 0.95,
        target_entropy: Optional[float] = None,
        backup_entropy: bool = False,
        device=None,
    ) -> "SACAgent":
        """Flat-state agent. `observations`/`actions` are example batches
        that give the widths; weights are drawn from `generator` on the CPU,
        then moved to `device` (default "cuda")."""
        obs_dim, action_dim = observations.shape[-1], actions.shape[-1]
        if target_entropy is None:
            target_entropy = -action_dim / 2
        pk = dict(policy_kwargs)
        actor = PolicyNet(
            obs_dim,
            action_dim,
            hidden_dims=tuple(policy_network_kwargs.get("hidden_dims", (256, 256))),
            activations=policy_network_kwargs.get("activations", "swish"),
            use_layer_norm=policy_network_kwargs.get("use_layer_norm", False),
            std_parameterization=pk.get("std_parameterization", "uniform"),
            std_min=pk.get("std_min", 1e-5),
            std_max=pk.get("std_max", 10.0),
            tanh_squash=pk.get("tanh_squash_distribution", True),
            fixed_std=pk.get("fixed_std"),
            generator=generator,
        )
        critic = CriticNet(
            obs_dim + action_dim,
            critic_ensemble_size,
            hidden_dims=tuple(critic_network_kwargs.get("hidden_dims", (256, 256))),
            activations=critic_network_kwargs.get("activations", "swish"),
            use_layer_norm=critic_network_kwargs.get("use_layer_norm", False),
            generator=generator,
        )
        config = SACConfig(
            discount=discount,
            target_entropy=float(target_entropy),
            backup_entropy=backup_entropy,
            critic_ensemble_size=critic_ensemble_size,
            critic_subsample_size=critic_subsample_size,
        )
        agent = cls(actor, critic, temperature_init, config)
        return agent.to(resolve_device(device))
