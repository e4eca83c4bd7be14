"""Soft Actor-Critic: acting and learning, from states or through an encoder.

Port of `serl_tpu/agents/sac.py`. The agent holds the same three parameter
groups as the JAX package: "actor" (PolicyNet), "critic" (the observation
encoder, if any, then the ensemble CriticNet) and "temperature" (one
softplus-parameterized scalar). Its `state` (common/train_state.py) keeps
one optimizer per group and the target critic, which carries a target
encoder. Updates change the agent's tensors in place.

With an encoder (pixel agents, `create_pixels`), only the critic loss
trains it: the policy encodes with the current critic encoder under
no_grad (JAX's stop_gradient), and the policy loss's pass through the
critic runs on detached params. As in the JAX package, the actor update
encodes its observations twice (for the policy, then for the critic).

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
The losses run the encoder in train mode, as the JAX package's pass
`train=True` and a dropout rng: an encoder whose pooling head has dropout
(the ResNet heads' learned spatial embeddings) drops features in every
encoder pass of a loss, each pass with its own keep-masks;
`sample_actions` runs it without. With the SmallEncoder ("avg" pooling)
train mode changes nothing.
Every draw (next-action noise per loss, subsample indices, actor noise,
dropout keep-masks) is taken from an explicit `draws` dict when one is
given (the tests feed the JAX package's draws that way) and from a
`torch.Generator` otherwise.

Observations may be tensors, dicts, or tuples of them, as the goal- and
language-conditioned encoders' (observations, goals) pairs: batches are
cut and checked leaf by leaf through dicts, tuples and lists. The encoder
is any module that takes the observations with `train` and `dropout`
(vision/encoding.py's, or one camera encoder alone, such as
vision/mobilenet.py's frozen backbone, whose one keep-mask is keyed
"encoder").
"""

from __future__ import annotations

from functools import partial
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from serl_tpu_torch import resolve_device
from serl_tpu_torch.agents.graphs import UpdateGraphs, _leaves, _map
from serl_tpu_torch.common.optimizers import make_optimizer, optimizer_lr
from serl_tpu_torch.common.train_state import TrainState
from serl_tpu_torch.distributed.sharding import exchange_minibatches, num_ranks, share_draws
from serl_tpu_torch.networks.actor_critic import CriticNet, PolicyNet, subsample_ensemble
from serl_tpu_torch.networks.lagrange import (
    init_lagrange_params,
    lagrange_penalty,
    lagrange_value,
)
from serl_tpu_torch.utils.timer import span
from serl_tpu_torch.vision.encoders import DROPOUT_RATE

NETWORKS = frozenset({"actor", "critic", "temperature"})


class SACConfig(NamedTuple):
    """Static agent configuration: the JAX package's SACConfig."""

    discount: float = 0.95
    soft_target_update_rate: float = 0.005
    target_entropy: float = 0.0
    backup_entropy: bool = False
    critic_ensemble_size: int = 2
    critic_subsample_size: Optional[int] = None
    image_keys: Tuple[str, ...] = ()
    has_encoder: bool = False
    augment: bool = True  # DrQ random crop of update batches
    # weight of the Q-filtered BC term on the actor (0 = off): see policy_loss_fn
    bc_regularization: float = 0.0
    vice_image_keys: Tuple[str, ...] = ()  # the VICE classifier's cameras (agents/vice.py)


def param_slots(module: nn.Module) -> List[Tuple[nn.Module, str, int]]:
    """(owner module, attribute, index in `module.parameters()`) of every
    parameter slot of `module`, a submodule that serves under two names (one
    encoder for every camera) once per name."""
    index = {id(p): i for i, p in enumerate(module.parameters())}
    slots = []
    for name, p in module.named_parameters(remove_duplicate=False):
        owner, _, attr = name.rpartition(".")
        slots.append((module.get_submodule(owner), attr, index[id(p)]))
    return slots


def call_with_params(module: nn.Module, slots, tensors: List[torch.Tensor], args: tuple,
                     kwargs: dict):
    """`module(*args, **kwargs)` with `tensors` (in `module.parameters()`
    order) in its parameter `slots` (`param_slots`), put back in the reverse
    order afterwards, so that a slot reached under two names ends holding its
    own parameter. torch.func.functional_call puts a tied module's slots back
    in the order it filled them, which leaves them holding the tensors it was
    given: a shared encoder would then compute with the target's copy and
    never train."""
    saved = []
    try:
        for owner, attr, i in slots:
            saved.append((owner, attr, owner._parameters[attr]))
            owner._parameters[attr] = tensors[i]
        return module(*args, **kwargs)
    finally:
        for owner, attr, p in reversed(saved):
            owner._parameters[attr] = p


def encoder_dropout_shapes(encoder: nn.Module, rows: int) -> Dict[str, tuple]:
    """{mask key: shape} of the keep-masks an encoder pass draws in train
    mode for `rows` observations; a camera encoder alone (it has
    `dropout_features`) draws one, keyed "encoder"."""
    if hasattr(encoder, "dropout_features"):
        f = encoder.dropout_features
        return {"encoder": (rows, f)} if f else {}
    return encoder.dropout_shapes(rows)


class SACAgent(nn.Module):
    def __init__(self, actor: PolicyNet, critic: CriticNet, temperature_init: float,
                 config: SACConfig, encoder: Optional[nn.Module] = None):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.encoder = encoder
        self.temperature_raw = nn.Parameter(init_lagrange_params(temperature_init)["raw"])
        self.config = config
        self.state: Optional[TrainState] = None  # set by init_train_state
        self._critic_names = [name for name, _ in critic.named_parameters()]
        self._encoder_slots = [] if encoder is None else param_slots(encoder)
        self._n_encoder = 0 if encoder is None else len(list(encoder.parameters()))
        # a camera encoder alone takes its one keep-mask, not a dict of them
        self._bare_encoder = hasattr(encoder, "dropout_features")
        self.graphs = UpdateGraphs()  # `update`'s CUDA graphs (agents/graphs.py)

    def critic_group(self) -> List[nn.Parameter]:
        """The "critic" group's tensors: the encoder's, then the head's."""
        enc = [] if self.encoder is None else list(self.encoder.parameters())
        return enc + list(self.critic.parameters())

    def init_train_state(self, actor_optimizer_kwargs: dict, critic_optimizer_kwargs: dict,
                         temperature_optimizer_kwargs: dict) -> "SACAgent":
        """Optimizers and the target critic for the agent's current tensors
        (call it after moving the agent to its device)."""
        self.state = TrainState(
            params={"actor": list(self.actor.parameters()),
                    "critic": self.critic_group(),
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

    def _encode(self, obs, params: Optional[List[torch.Tensor]] = None, train: bool = False,
                dropout: Optional[Dict[str, torch.Tensor]] = None):
        """Observations -> flat features through the encoder, if any, with
        `params` (the encoder's tensors) in place of its own when given;
        `train` turns on the encoder's dropout, with the keep-masks
        `dropout` ({image key: mask}) where given."""
        if self.encoder is None:
            return obs
        if dropout is not None and self._bare_encoder:  # one camera encoder: its one mask
            dropout = dropout.get("encoder")
        kwargs = {"train": train, "dropout": dropout}
        if params is None:
            return self.encoder(obs, **kwargs)
        return call_with_params(self.encoder, self._encoder_slots, params, (obs,), kwargs)

    def forward_policy(self, obs, *, temperature: float = 1.0, train: bool = False,
                       dropout: Optional[Dict[str, torch.Tensor]] = None):
        with torch.no_grad():  # the actor never trains the encoder
            feats = self._encode(obs, train=train, dropout=dropout)
        return self.actor(feats, temperature=temperature)

    def forward_critic(self, obs, actions: torch.Tensor,
                       params: Optional[List[torch.Tensor]] = None, train: bool = False,
                       dropout: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """(E, B) Q-values; `params` (in `critic_group()` order: encoder,
        then head) replaces the critic's own tensors, as for the target
        critic."""
        if params is None:
            return self.critic(self._encode(obs, train=train, dropout=dropout), actions)
        n = self._n_encoder
        feats = self._encode(obs, params[:n], train, dropout)
        return functional_call(self.critic, dict(zip(self._critic_names, params[n:])),
                               (feats, actions))

    def temperature(self) -> torch.Tensor:
        return lagrange_value({"raw": self.temperature_raw})

    @torch.no_grad()
    def sample_actions(
        self,
        observations,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        argmax: bool = False,
        temperature: float = 1.0,
    ) -> torch.Tensor:
        """Actions for a batch of observations: the distribution's mode when
        `argmax`, else a sample with standard-normal `noise` if given, drawn
        from `generator` otherwise."""
        with span("policy.sample"):
            dist = self.forward_policy(observations, temperature=temperature)
            if argmax:
                return dist.mode()
            return dist.sample(generator=generator, eps=noise)

    # ------------------------------------------------------------------ #
    # Losses
    # ------------------------------------------------------------------ #

    def critic_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        with torch.no_grad():
            dist = self.forward_policy(batch["next_observations"], train=True,
                                       dropout=draws.get("critic_next_dropout"))
            next_actions, next_log_probs = dist.sample_and_log_prob(eps=draws["critic_next_eps"])
            target_next_qs = self.forward_critic(batch["next_observations"], next_actions,
                                                 params=self.state.target_params["critic"],
                                                 train=True, dropout=draws.get("target_dropout"))
            target_next_qs = subsample_ensemble(
                target_next_qs, self.config.critic_subsample_size,
                self.config.critic_ensemble_size, idx=draws.get("subsample_idx"))
            target_next_min_q = target_next_qs.min(0).values
            target_q = (batch["rewards"]
                        + self.config.discount * batch["masks"] * target_next_min_q)
            if self.config.backup_entropy:
                target_q = target_q - self.temperature() * next_log_probs
        predicted_qs = self.forward_critic(batch["observations"], batch["actions"], train=True,
                                           dropout=draws.get("critic_dropout"))
        critic_loss = ((predicted_qs - target_q[None]) ** 2).mean()
        return critic_loss, {
            "critic_loss": critic_loss.detach(),
            "predicted_qs": predicted_qs.detach().mean(),
            "target_qs": target_q.mean(),
        }

    def policy_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        temperature = self.temperature().detach()
        dist = self.forward_policy(batch["observations"], train=True,
                                   dropout=draws.get("actor_dropout"))
        actions, log_probs = dist.sample_and_log_prob(eps=draws["actor_eps"])
        critic_params = [p.detach() for p in self.state.params["critic"]]
        critic = partial(self.forward_critic, batch["observations"], params=critic_params,
                         train=True, dropout=draws.get("actor_critic_dropout"))
        predicted_q = critic(actions).mean(0)
        actor_loss = -(predicted_q - temperature * log_probs).mean()
        info = {
            "actor_loss": actor_loss.detach(),
            "temperature": temperature,
            "entropy": -log_probs.detach().mean(),
        }
        if self.config.bc_regularization > 0.0:
            # Q-filtered behaviour cloning (Nair et al.): pull the policy toward
            # the batch's actions only where the critic rates them above the
            # policy's own sample (JAX passes the same critic rng, so the
            # same dropout masks, to both critic passes)
            batch_a = torch.clamp(batch["actions"], -0.999, 0.999)
            with torch.no_grad():
                better = (critic(batch_a).mean(0) > predicted_q).to(torch.float32)
            # a mean over the rows the critic rates better, of the global batch
            # under data parallelism: the count is summed over the ranks, and
            # the rank's sum scaled by their number, so that the gradients'
            # average over the ranks is the global batch's gradient
            count, scale = better.sum(), 1.0
            if self.state.dp is not None:
                count, scale = self.state.dp.all_reduce_sum_(count), self.state.dp.world_size
            bc_loss = scale * (better * -dist.log_prob(batch_a)).sum() / torch.clamp(count, min=1.0)
            actor_loss = actor_loss + self.config.bc_regularization * bc_loss
            info.update(actor_loss=actor_loss.detach(), bc_loss=bc_loss.detach(),
                        bc_active_frac=better.mean())
        return actor_loss, info

    def temperature_loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        with torch.no_grad():
            dist = self.forward_policy(batch["next_observations"], train=True,
                                       dropout=draws.get("temperature_next_dropout"))
            _, next_log_probs = dist.sample_and_log_prob(eps=draws["temperature_next_eps"])
            entropy = -next_log_probs.mean()
        loss = lagrange_penalty({"raw": self.temperature_raw}, lhs=entropy,
                                rhs=self.config.target_entropy)
        return loss, {"temperature_loss": loss.detach()}

    # ------------------------------------------------------------------ #
    # Updates
    # ------------------------------------------------------------------ #

    def loss_fns(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]) -> Dict:
        """Every train-state group's loss on `batch` (a subclass adds its own
        groups; `update` zeroes the groups it does not update)."""
        return {
            "critic": partial(self.critic_loss_fn, batch, draws),
            "actor": partial(self.policy_loss_fn, batch, draws),
            "temperature": partial(self.temperature_loss_fn, batch, draws),
        }

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
        # the encoder's dropout keep-masks, one set per encoder pass of the losses
        shapes = {} if self.encoder is None else encoder_dropout_shapes(self.encoder, batch_size)
        if shapes:
            passes = {"critic": ("critic_next", "target", "critic"),
                      "actor": ("actor", "actor_critic"), "temperature": ("temperature_next",)}
            keep = 1.0 - DROPOUT_RATE
            for net in sorted(networks_to_update):
                for name in passes[net]:
                    draws[f"{name}_dropout"] = {
                        k: torch.rand(shape, generator=generator, device=device) < keep
                        for k, shape in shapes.items()}
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
        with zero gradients. On the card the step after the draws is a CUDA
        graph's replay wherever agents/graphs.py can capture it."""
        batch_size = batch["rewards"].shape[0]
        for k, v in batch.items():
            if any(x.shape[0] != batch_size for x in _leaves(v)):
                raise ValueError(f"batch[{k!r}] has a leaf whose rows differ from rewards' "
                                 f"{batch_size}")
        networks_to_update = frozenset(networks_to_update)
        if not networks_to_update <= NETWORKS:
            raise ValueError(f"unknown networks {sorted(networks_to_update - NETWORKS)}")
        if draws is None and self.state.dp is not None:
            raise ValueError("under data parallelism `update` takes the rank's draws "
                             "(update_high_utd cuts them from the global batch's)")
        if draws is None:
            draws = self.update_draws(batch_size, networks_to_update, generator)
        info = self.graphs.run(self, batch, draws, networks_to_update)
        if info is None:
            info = self._step(batch, draws, networks_to_update)
        for name, opt_state in self.state.opt_states.items():
            info[f"{name}_lr"] = optimizer_lr(opt_state)
        return self, info

    def _step(self, batch: Dict, draws: Dict, networks_to_update: FrozenSet[str],
              scalars: Optional[torch.Tensor] = None) -> Dict:
        """`update`'s losses, gradients, optimizer steps and target update;
        returns the infos by group. With `scalars` (on the device, as
        `TrainState.apply_gradients` takes them) the device side only, which
        agents/graphs.py captures."""
        loss_fns = self.loss_fns(batch, draws)
        for key in set(loss_fns) - networks_to_update:
            loss_fns[key] = None
        info = self.state.apply_loss_fns(loss_fns, scalars)
        if "critic" in networks_to_update:
            self.state.target_update(self.config.soft_target_update_rate)
        return info

    def update_high_utd(self, batch: Dict[str, torch.Tensor], *, utd_ratio: int,
                        draws: Optional[List[Dict]] = None,
                        generator: Optional[torch.Generator] = None):
        """`utd_ratio` critic updates on contiguous minibatches, then one
        actor+temperature update on the full batch; returns (self, info).

        Under data parallelism (a handle in `self.state.dp`) `batch` is this
        rank's contiguous block of the global batch (the replay buffers'
        `sample(dp=)`): one all-to-all hands the rank its share of every
        minibatch (`distributed/sharding.py::exchange_minibatches`), and
        `draws`, given or drawn, are the global batch's, cut to those rows."""
        with span("learner.update"):
            dp = self.state.dp
            batch_size = batch["rewards"].shape[0] * num_ranks(dp)
            if batch_size % utd_ratio != 0:
                raise ValueError(f"batch size {batch_size} does not divide by utd_ratio "
                                 f"{utd_ratio}")
            if draws is None:
                with span("learner.draws"):
                    draws = self.high_utd_draws(batch_size, utd_ratio, generator)
            if dp is not None:
                batch = exchange_minibatches(batch, utd_ratio, dp)
                draws = share_draws(draws, batch_size, utd_ratio, dp)
            minibatch_size = batch["rewards"].shape[0] // utd_ratio
            critic_infos = []
            for i in range(utd_ratio):
                rows = slice(i * minibatch_size, (i + 1) * minibatch_size)
                with span("learner.critic"):
                    _, info = self.update(_map(lambda v: v[rows], batch),
                                          networks_to_update=frozenset({"critic"}), draws=draws[i])
                critic_infos.append(info)
            critic_info = _mean_infos(critic_infos)
            critic_info.pop("actor", None)
            critic_info.pop("temperature", None)
            with span("learner.actor"):
                _, actor_temp_info = self.update(
                    batch, networks_to_update=frozenset({"actor", "temperature"}),
                    draws=draws[utd_ratio])
            actor_temp_info.pop("critic", None)
            return self, {**critic_info, **actor_temp_info}

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def create(
        cls,
        features_dim: int,
        action_dim: int,
        *,
        encoder: Optional[nn.Module] = None,
        image_keys: Tuple[str, ...] = (),
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
        bc_regularization: float = 0.0,
        device=None,
    ) -> "SACAgent":
        """An agent whose networks read `features_dim` features (the
        observation width, or the encoder's output); weights are drawn from
        `generator` on the CPU, then everything moves to `device` (default
        "cuda"). A kwargs dict left as None takes the JAX package's defaults:
        hidden (256, 256), a tanh-squashed policy with uniform std, lr 3e-4
        and 2000 warmup steps for actor and critic, lr 3e-4 for the
        temperature."""
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
            features_dim,
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
            features_dim + action_dim,
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
            image_keys=tuple(image_keys),
            has_encoder=encoder is not None,
            bc_regularization=float(bc_regularization),
        )
        agent = cls(actor, critic, temperature_init, config, encoder).to(resolve_device(device))
        return agent.init_train_state(actor_optimizer_kwargs, critic_optimizer_kwargs,
                                      temperature_optimizer_kwargs)

    @classmethod
    def create_states(cls, observations: torch.Tensor, actions: torch.Tensor,
                      **kwargs) -> "SACAgent":
        """Flat-state agent; `observations`/`actions` are example batches
        that give the widths. kwargs as `create`."""
        return cls.create(observations.shape[-1], actions.shape[-1], **kwargs)

    @classmethod
    def create_pixels(cls, observations: Dict, actions: torch.Tensor, *, encoder: nn.Module,
                      image_keys: Tuple[str, ...] = ("image",), **kwargs) -> "SACAgent":
        """Pixel agent whose networks read `encoder`'s features of dict
        observations (the encoder joins the "critic" group). `observations`
        is an example batch, run once through the encoder to check that it
        takes it. kwargs as `create`."""
        with torch.no_grad():
            feats = encoder(observations)
        if feats.shape[-1] != encoder.out_features:
            raise ValueError(f"encoder gives {feats.shape[-1]} features, says {encoder.out_features}")
        return cls.create(encoder.out_features, actions.shape[-1], encoder=encoder,
                          image_keys=tuple(image_keys), **kwargs)


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
