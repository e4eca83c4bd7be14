"""Policy and critic networks.

Port of `serl_tpu/networks/actor_critic.py` (PolicyNet, CriticNet,
subsample_ensemble). As in
the JAX package, the critic ensemble is an `EnsembleMLP` with a leading
ensemble axis on the kernels, and encoders live outside these modules.
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
        std_parameterization: str = "exp",
        std_min: float = 1e-5,
        std_max: float = 10.0,
        tanh_squash: bool = True,
        fixed_std: Optional[Sequence[float]] = None,
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
                         use_layer_norm=use_layer_norm, generator=generator)
        h = hidden_dims[-1]
        self.mean = dense(h, action_dim, generator)
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

    def forward(self, features: torch.Tensor, temperature: float = 1.0):
        x = self.trunk(features)
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
    (The JAX module's (B, A, action_dim) action batches have no caller in
    the acting path and are not ported yet.)"""

    def __init__(
        self,
        in_features: int,
        ensemble_size: int,
        hidden_dims: Sequence[int] = (256, 256),
        activations: Union[str, Callable] = "swish",
        use_layer_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ensemble_size = ensemble_size
        self.trunk = EnsembleMLP(ensemble_size, in_features, hidden_dims, activations,
                                 activate_final=True, use_layer_norm=use_layer_norm,
                                 generator=generator)
        self.head = EnsembleDense(ensemble_size, hidden_dims[-1], 1, generator=generator)

    def forward(self, features: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        x = self.trunk(torch.cat([features, actions], -1))
        return self.head(x, member_inputs=True).squeeze(-1)


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
