"""Soft Actor-Critic for state observations: acting and learning.

Port of `serl_tpu/agents/sac.py` for state agents. The agent holds the same
three parameter groups as the JAX package: "actor" (PolicyNet), "critic"
(the ensemble CriticNet; its "encoder" group is empty for state
observations) and "temperature" (one softplus-parameterized scalar). Its
`state` (common/train_state.py) keeps one optimizer per group and the target
critic. Updates change the agent's tensors in place.

The learner's traps, kept as in the JAX package:
  * the critic target's next actions come from the pre-step actor and carry
    no gradient; the target Q is subsample -> min over the target ensemble;
  * the policy loss averages ALL ensemble members and reads the critic and
    the temperature as constants (the critic runs on detached params, so
    its LayerNorm backward computes no weight grads);
  * the temperature loss takes its entropy from next_observations;
  * a group left out of an update still steps its optimizer with zero
    grads (Adam's momentum keeps moving it), and `update_high_utd` runs
    `utd_ratio` critic-only updates on contiguous minibatches, then one
    actor+temperature update on the full batch, in which the critic steps
    with zero grads and its target stays.
Every draw (next-action noise per loss, subsample indices, actor noise) is
taken from an explicit `draws` dict when one is given (the tests feed the
JAX package's draws that way) and from a `torch.Generator` otherwise.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, FrozenSet, List, NamedTuple, Optional

import torch
from torch import nn
from torch.func import functional_call

from serl_tpu_torch import resolve_device
from serl_tpu_torch.common.optimizers import make_optimizer, optimizer_lr
from serl_tpu_torch.common.train_state import TrainState
from serl_tpu_torch.networks.actor_critic import CriticNet, PolicyNet, subsample_ensemble
from serl_tpu_torch.networks.lagrange import (
    init_lagrange_params,
    lagrange_penalty,
    lagrange_value,
)

NETWORKS = frozenset({"actor", "critic", "temperature"})


class SACConfig(NamedTuple):
    """Static agent configuration: the JAX package's SACConfig for state
    agents (its image-key and encoder fields wait for the pixel agents)."""

    discount: float = 0.95
    soft_target_update_rate: float = 0.005
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
        self.state: Optional[TrainState] = None  # set by init_train_state
        self._critic_names = [name for name, _ in critic.named_parameters()]

    def init_train_state(self, actor_optimizer_kwargs: dict, critic_optimizer_kwargs: dict,
                         temperature_optimizer_kwargs: dict) -> "SACAgent":
        """Optimizers and the target critic for the agent's current tensors
        (call it after moving the agent to its device)."""
        self.state = TrainState(
            params={"actor": list(self.actor.parameters()),
                    "critic": list(self.critic.parameters()),
                    "temperature": [self.temperature_raw]},
            txs={"actor": make_optimizer(**actor_optimizer_kwargs),
                 "critic": make_optimizer(**critic_optimizer_kwargs),
                 "temperature": make_optimizer(**temperature_optimizer_kwargs)},
            target_groups=("critic",),
        )
        return self

    # ------------------------------------------------------------------ #
    # Forward passes
    # ------------------------------------------------------------------ #

    def forward_policy(self, obs: torch.Tensor, *, temperature: float = 1.0):
        return self.actor(obs, temperature=temperature)

    def forward_critic(self, obs: torch.Tensor, actions: torch.Tensor,
                       params: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """(E, B) Q-values; `params` (in `critic.parameters()` order) replaces
        the critic's own tensors, as for the target critic."""
        if params is None:
            return self.critic(obs, actions)
        return functional_call(self.critic, dict(zip(self._critic_names, params)), (obs, actions))

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
    # Losses
    # ------------------------------------------------------------------ #

    def critic_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        with torch.no_grad():
            dist = self.forward_policy(batch["next_observations"])
            next_actions, next_log_probs = dist.sample_and_log_prob(eps=draws["critic_next_eps"])
            target_next_qs = self.forward_critic(batch["next_observations"], next_actions,
                                                 params=self.state.target_params["critic"])
            target_next_qs = subsample_ensemble(
                target_next_qs, self.config.critic_subsample_size,
                self.config.critic_ensemble_size, idx=draws.get("subsample_idx"))
            target_next_min_q = target_next_qs.min(0).values
            target_q = (batch["rewards"]
                        + self.config.discount * batch["masks"] * target_next_min_q)
            if self.config.backup_entropy:
                target_q = target_q - self.temperature() * next_log_probs
        predicted_qs = self.forward_critic(batch["observations"], batch["actions"])
        critic_loss = ((predicted_qs - target_q[None]) ** 2).mean()
        return critic_loss, {
            "critic_loss": critic_loss.detach(),
            "predicted_qs": predicted_qs.detach().mean(),
            "target_qs": target_q.mean(),
        }

    def policy_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        temperature = self.temperature().detach()
        dist = self.forward_policy(batch["observations"])
        actions, log_probs = dist.sample_and_log_prob(eps=draws["actor_eps"])
        critic_params = [p.detach() for p in self.state.params["critic"]]
        predicted_q = self.forward_critic(batch["observations"], actions,
                                          params=critic_params).mean(0)
        actor_loss = -(predicted_q - temperature * log_probs).mean()
        return actor_loss, {
            "actor_loss": actor_loss.detach(),
            "temperature": temperature,
            "entropy": -log_probs.detach().mean(),
        }

    def temperature_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        with torch.no_grad():
            dist = self.forward_policy(batch["next_observations"])
            _, next_log_probs = dist.sample_and_log_prob(eps=draws["temperature_next_eps"])
            entropy = -next_log_probs.mean()
        loss = lagrange_penalty({"raw": self.temperature_raw}, lhs=entropy,
                                rhs=self.config.target_entropy)
        return loss, {"temperature_loss": loss.detach()}

    # ------------------------------------------------------------------ #
    # Updates
    # ------------------------------------------------------------------ #

    def update_draws(self, batch_size: int, networks_to_update: FrozenSet[str] = NETWORKS,
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The random numbers one `update` of these networks reads."""
        device = self.temperature_raw.device
        shape = (batch_size, self.actor.mean.out_features)
        normal = partial(torch.randn, shape, generator=generator, device=device)
        draws = {}
        if "critic" in networks_to_update:
            draws["critic_next_eps"] = normal()
            if self.config.critic_subsample_size is not None:
                draws["subsample_idx"] = torch.randint(
                    0, self.config.critic_ensemble_size, (self.config.critic_subsample_size,),
                    generator=generator, device=device)
        if "actor" in networks_to_update:
            draws["actor_eps"] = normal()
        if "temperature" in networks_to_update:
            draws["temperature_next_eps"] = normal()
        return draws

    def high_utd_draws(self, batch_size: int, utd_ratio: int,
                       generator: Optional[torch.Generator] = None) -> List[Dict]:
        """The draws of one `update_high_utd`: one dict per critic minibatch
        update, then one for the actor+temperature update."""
        minibatch = batch_size // utd_ratio
        return ([self.update_draws(minibatch, frozenset({"critic"}), generator)
                 for _ in range(utd_ratio)]
                + [self.update_draws(batch_size, frozenset({"actor", "temperature"}), generator)])

    def update(self, batch: Dict[str, torch.Tensor], *,
               networks_to_update: FrozenSet[str] = NETWORKS,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
        """One gradient step on all (or a subset) of the networks, in place;
        returns (self, info). Skipped networks still step their optimizer
        with zero gradients."""
        batch_size = batch["rewards"].shape[0]
        for k, v in batch.items():
            if v.shape[0] != batch_size:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, rewards {batch_size}")
        networks_to_update = frozenset(networks_to_update)
        if not networks_to_update <= NETWORKS:
            raise ValueError(f"unknown networks {sorted(networks_to_update - NETWORKS)}")
        if draws is None:
            draws = self.update_draws(batch_size, networks_to_update, generator)
        loss_fns = {
            "critic": partial(self.critic_loss_fn, batch, draws),
            "actor": partial(self.policy_loss_fn, batch, draws),
            "temperature": partial(self.temperature_loss_fn, batch, draws),
        }
        for key in NETWORKS - networks_to_update:
            loss_fns[key] = None
        info = self.state.apply_loss_fns(loss_fns)
        if "critic" in networks_to_update:
            self.state.target_update(self.config.soft_target_update_rate)
        for name, opt_state in self.state.opt_states.items():
            info[f"{name}_lr"] = optimizer_lr(opt_state)
        return self, info

    def update_high_utd(self, batch: Dict[str, torch.Tensor], *, utd_ratio: int,
                        draws: Optional[List[Dict]] = None,
                        generator: Optional[torch.Generator] = None):
        """`utd_ratio` critic updates on contiguous minibatches, then one
        actor+temperature update on the full batch; returns (self, info)."""
        batch_size = batch["rewards"].shape[0]
        if batch_size % utd_ratio != 0:
            raise ValueError(f"batch size {batch_size} does not divide by utd_ratio {utd_ratio}")
        minibatch_size = batch_size // utd_ratio
        if draws is None:
            draws = self.high_utd_draws(batch_size, utd_ratio, generator)
        critic_infos = []
        for i in range(utd_ratio):
            rows = slice(i * minibatch_size, (i + 1) * minibatch_size)
            _, info = self.update({k: v[rows] for k, v in batch.items()},
                                  networks_to_update=frozenset({"critic"}), draws=draws[i])
            critic_infos.append(info)
        critic_info = _mean_infos(critic_infos)
        critic_info.pop("actor", None)
        critic_info.pop("temperature", None)
        _, actor_temp_info = self.update(batch, networks_to_update=frozenset({"actor", "temperature"}),
                                         draws=draws[utd_ratio])
        actor_temp_info.pop("critic", None)
        return self, {**critic_info, **actor_temp_info}

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
        critic_network_kwargs: Optional[dict] = None,
        policy_network_kwargs: Optional[dict] = None,
        policy_kwargs: Optional[dict] = None,
        critic_ensemble_size: int = 2,
        critic_subsample_size: Optional[int] = None,
        temperature_init: float = 1.0,
        actor_optimizer_kwargs: Optional[dict] = None,
        critic_optimizer_kwargs: Optional[dict] = None,
        temperature_optimizer_kwargs: Optional[dict] = None,
        discount: float = 0.95,
        soft_target_update_rate: float = 0.005,
        target_entropy: Optional[float] = None,
        backup_entropy: bool = False,
        device=None,
    ) -> "SACAgent":
        """Flat-state agent. `observations`/`actions` are example batches
        that give the widths; weights are drawn from `generator` on the CPU,
        then moved to `device` (default "cuda"). A kwargs dict left as None
        takes the JAX package's defaults: hidden (256, 256), a tanh-squashed
        policy with uniform std, lr 3e-4 and 2000 warmup steps for actor and
        critic, lr 3e-4 for the temperature."""
        obs_dim, action_dim = observations.shape[-1], actions.shape[-1]
        if target_entropy is None:
            target_entropy = -action_dim / 2
        critic_network_kwargs = critic_network_kwargs or {}
        policy_network_kwargs = policy_network_kwargs or {}
        pk = policy_kwargs or {}
        if actor_optimizer_kwargs is None:
            actor_optimizer_kwargs = {"learning_rate": 3e-4, "warmup_steps": 2000}
        if critic_optimizer_kwargs is None:
            critic_optimizer_kwargs = {"learning_rate": 3e-4, "warmup_steps": 2000}
        if temperature_optimizer_kwargs is None:
            temperature_optimizer_kwargs = {"learning_rate": 3e-4}
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
            soft_target_update_rate=soft_target_update_rate,
            target_entropy=float(target_entropy),
            backup_entropy=backup_entropy,
            critic_ensemble_size=critic_ensemble_size,
            critic_subsample_size=critic_subsample_size,
        )
        agent = cls(actor, critic, temperature_init, config).to(resolve_device(device))
        return agent.init_train_state(actor_optimizer_kwargs, critic_optimizer_kwargs,
                                      temperature_optimizer_kwargs)


def _mean_infos(infos: List[Dict]) -> Dict:
    """Leaf-wise mean of a list of equally nested info dicts."""
    out = {}
    for k, v in infos[0].items():
        if isinstance(v, dict):
            out[k] = _mean_infos([i[k] for i in infos])
        elif isinstance(v, torch.Tensor):
            out[k] = torch.stack([i[k] for i in infos]).mean(0)
        else:
            out[k] = sum(i[k] for i in infos) / len(infos)
    return out
