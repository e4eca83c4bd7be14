"""Policy and critic networks.

Port of `serl_tpu/networks/actor_critic.py`: PolicyNet, CriticNet (with
(B, A, action) batches of A actions per row, folded into the batch),
ValueCritic, DistributionalCriticNet (C51 logits and atoms),
ContrastiveCritic (CRL's outer product of state-action and goal towers) and
subsample_ensemble. As in the JAX package, the critic ensemble is an
`EnsembleMLP` with a leading ensemble axis on the kernels, and encoders
live outside these modules.

`init_final` draws the final layer's kernel as the JAX modules do: they
call flax's `uniform(-f, f)`, whose first argument is the scale of a
uniform draw on [0, scale), so the kernel is uniform on (-f, 0]; kept.
Dropout (`dropout_rate`) acts in train mode on the trunk's layers, each
keep-mask given by the caller (networks/mlp.py).
"""

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.common.distributions import Normal, TanhNormal
from serl_tpu_torch.networks.mlp import MLP, EnsembleDense, EnsembleMLP, dense


class PolicyNet(nn.Module):
    """Gaussian policy head: MLP trunk -> mean (+ std parameterization).

    std_parameterization: "exp" | "softplus" | "uniform" (state-independent
    learned log-std) | "fixed".
    """

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_dims: Sequence[int] = (256, 256),
        activations: Union[str, Callable] = "swish",
        use_layer_norm: bool = False,
        dropout_rate: Optional[float] = None,
        std_parameterization: str = "exp",
        std_min: float = 1e-5,
        std_max: float = 10.0,
        tanh_squash: bool = True,
        fixed_std: Optional[Sequence[float]] = None,
        init_final: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if fixed_std is not None and std_parameterization != "fixed":
            raise ValueError("fixed_std needs std_parameterization='fixed'")
        if std_parameterization not in ("exp", "softplus", "uniform", "fixed"):
            raise ValueError(std_parameterization)
        self.std_parameterization = std_parameterization
        self.std_min, self.std_max = std_min, std_max
        self.tanh_squash = tanh_squash
        self.trunk = MLP(obs_dim, hidden_dims, activations, activate_final=True,
                         use_layer_norm=use_layer_norm, dropout_rate=dropout_rate,
                         generator=generator)
        h = hidden_dims[-1]
        self.mean = dense(h, action_dim, generator)
        if init_final is not None:
            final_uniform_(self.mean.weight, init_final, generator)
        self.std_head = None
        self.log_stds = None
        if std_parameterization in ("exp", "softplus"):
            self.std_head = dense(h, action_dim, generator)
        elif std_parameterization == "uniform":
            self.log_stds = nn.Parameter(torch.zeros(action_dim))
        self.register_buffer(
            "fixed_std",
            None if fixed_std is None else torch.as_tensor(fixed_std, dtype=torch.float32),
        )

    def forward(self, features: torch.Tensor, temperature: float = 1.0, train: bool = False,
                dropout: Optional[Sequence[torch.Tensor]] = None):
        x = self.trunk(features, train, dropout)
        means = self.mean(x)
        if self.std_parameterization == "fixed":
            stds = self.fixed_std
        elif self.std_parameterization == "exp":
            stds = torch.exp(self.std_head(x))
        elif self.std_parameterization == "softplus":
            stds = F.softplus(self.std_head(x))
        else:
            stds = torch.exp(self.log_stds)
        # the clip comes BEFORE the sqrt(temperature) factor (MaxEnt std scale)
        stds = torch.clamp(stds, self.std_min, self.std_max) * math.sqrt(temperature)
        stds = stds.expand(means.shape)
        if self.tanh_squash:
            return TanhNormal(loc=means, scale=stds)
        return Normal(loc=means, scale=stds)


class CriticNet(nn.Module):
    """Ensemble Q-network: concat(features, actions) -> EnsembleMLP -> (E, B).
    Actions (B, A, action_dim) give (E, B, A): each row's features repeated
    A times, the A axis folded into the batch and unfolded at the end."""

    def __init__(
        self,
        in_features: int,
        ensemble_size: int,
        hidden_dims: Sequence[int] = (256, 256),
        activations: Union[str, Callable] = "swish",
        use_layer_norm: bool = False,
        dropout_rate: Optional[float] = None,
        init_final: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ensemble_size = ensemble_size
        self.trunk = EnsembleMLP(ensemble_size, in_features, hidden_dims, activations,
                                 activate_final=True, use_layer_norm=use_layer_norm,
                                 dropout_rate=dropout_rate, generator=generator)
        self.head = EnsembleDense(ensemble_size, hidden_dims[-1], 1, generator=generator)
        if init_final is not None:
            final_uniform_(self.head.kernel, init_final, generator)

    def forward(self, features: torch.Tensor, actions: torch.Tensor, train: bool = False,
                dropout: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        if actions.dim() == features.dim() + 1:
            num_a = actions.shape[-2]
            feat = features.unsqueeze(-2).expand(*features.shape[:-1], num_a, features.shape[-1])
            q = self._q(feat.reshape(-1, features.shape[-1]),
                        actions.reshape(-1, actions.shape[-1]), train, dropout)
            return q.reshape(self.ensemble_size, -1, num_a)
        return self._q(features, actions, train, dropout)

    def _q(self, features, actions, train, dropout):
        x = self.trunk(torch.cat([features, actions], -1), train, dropout)
        return self.head(x, member_inputs=True).squeeze(-1)


class ValueCritic(nn.Module):
    """State value V(s): MLP (activate_final) -> Dense(1), squeezed to (B,)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int] = (256, 256),
                 activations: Union[str, Callable] = "swish", use_layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = MLP(in_features, hidden_dims, activations, activate_final=True,
                         use_layer_norm=use_layer_norm, generator=generator)
        self.value = dense(hidden_dims[-1], 1, generator)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.value(self.trunk(features)).squeeze(-1)


class DistributionalCriticNet(nn.Module):
    """C51 categorical critic: concat(features, actions) -> EnsembleMLP ->
    (E, B, num_atoms) logits, and the atoms linspace(q_low, q_high,
    num_atoms) broadcast to the logits' shape."""

    def __init__(self, in_features: int, ensemble_size: int, q_low: float, q_high: float,
                 num_atoms: int = 51, hidden_dims: Sequence[int] = (256, 256),
                 activations: Union[str, Callable] = "swish", use_layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trunk = EnsembleMLP(ensemble_size, in_features, hidden_dims, activations,
                                 activate_final=True, use_layer_norm=use_layer_norm,
                                 generator=generator)
        self.logits = EnsembleDense(ensemble_size, hidden_dims[-1], num_atoms,
                                    generator=generator)
        self.register_buffer("atoms", torch.linspace(q_low, q_high, num_atoms),
                             persistent=False)

    def forward(self, features: torch.Tensor, actions: torch.Tensor):
        x = self.trunk(torch.cat([features, actions], -1))
        logits = self.logits(x, member_inputs=True)
        return logits, self.atoms.expand(logits.shape)


class ContrastiveCritic(nn.Module):
    """CRL's contrastive critic. The features are two halves of equal width,
    the observation's then the goal's encoding; the state-action tower reads
    (obs half, action), the goal tower the goal half, each an MLP
    (activate_final) and a Dense to `repr_dim`; the logits are the outer
    product (B, B) of the two representations, with `twin_q` a second pair
    of towers stacked last: (B, B, 2). flax names: sa_mlp, sa_proj, g_mlp,
    g_proj, then sa2_* and g2_*."""

    def __init__(self, features: int, action_dim: int, sa_hidden_dims: Sequence[int] = (256, 256),
                 g_hidden_dims: Sequence[int] = (256, 256), repr_dim: int = 16,
                 twin_q: bool = True, activations: Union[str, Callable] = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_dim = features // 2
        goal_dim = features - self.enc_dim

        def tower(in_features, dims):
            return nn.ModuleDict({"mlp": MLP(in_features, dims, activations, activate_final=True,
                                             generator=generator),
                                  "proj": dense(dims[-1], repr_dim, generator)})

        names = ("sa", "g", "sa2", "g2") if twin_q else ("sa", "g")
        self.towers = nn.ModuleDict({
            name: tower(self.enc_dim + action_dim if name.startswith("sa") else goal_dim,
                        sa_hidden_dims if name.startswith("sa") else g_hidden_dims)
            for name in names})

    def forward(self, features: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        obs_enc, goal_enc = features[..., :self.enc_dim], features[..., self.enc_dim:]
        sa_in = torch.cat([obs_enc, actions], -1)

        def rep(name, x):
            return self.towers[name]["proj"](self.towers[name]["mlp"](x))

        outer = rep("sa", sa_in) @ rep("g", goal_enc).t()
        if "sa2" in self.towers:
            outer = torch.stack([outer, rep("sa2", sa_in) @ rep("g2", goal_enc).t()], -1)
        return outer


def final_uniform_(w: torch.Tensor, init_final: float, generator=None) -> torch.Tensor:
    """The JAX modules' `init_final` kernel: uniform on (-init_final, 0] (see
    the module docstring)."""
    with torch.no_grad():
        return w.uniform_(-init_final, 0.0, generator=generator)


def subsample_ensemble(qs: torch.Tensor, subsample_size: Optional[int], ensemble_size: int,
                       *, idx: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """REDQ ensemble subsampling: `subsample_size` member indices drawn with
    replacement (`idx` when given, else from `generator`); all of `qs` when
    `subsample_size` is None."""
    if subsample_size is None:
        return qs
    if idx is None:
        idx = torch.randint(0, ensemble_size, (subsample_size,), generator=generator,
                            device=qs.device)
    return qs[idx.to(qs.device)]
