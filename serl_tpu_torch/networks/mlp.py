"""MLP family, including a batched ensemble MLP.

Port of `serl_tpu/networks/mlp.py` (MLP, EnsembleDense, EnsembleMLP). The
ensemble is a leading axis on the weights: `EnsembleDense` keeps the JAX
package's (E, in, out) kernel layout and contracts it with one batched
matmul. Two flax conventions are kept on purpose:
  * LayerNorm epsilon is flax's 1e-6, not torch's 1e-5;
  * `EnsembleMLP` has ONE LayerNorm per layer, shared by all members.
A LayerNorm followed by tanh goes through K5, `layer_norm_tanh` (one
autograd op; a Triton kernel on the card). The `nn.LayerNorm` modules hold
its weight and bias. Any other activation after a LayerNorm runs as plain
torch ops: it is another function, not a fallback.
Weights are initialized like flax's defaults (xavier-uniform kernels, zero
biases) from an explicit `torch.Generator`.
"""

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.networks.layer_norm_tanh import LAYER_NORM_EPS, layer_norm_tanh

_ACTIVATIONS = {"tanh": torch.tanh, "swish": F.silu}  # flax's names


def resolve_activation(act: Union[str, Callable]) -> Callable:
    return _ACTIVATIONS[act] if isinstance(act, str) else act


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def dense(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """nn.Linear initialized like flax's Dense (xavier-uniform, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        xavier_uniform_(layer.weight, in_features, out_features, generator)
        layer.bias.zero_()
    return layer


def _norm_act(x: torch.Tensor, norm: Optional[nn.LayerNorm], act: Callable) -> torch.Tensor:
    """Optional LayerNorm, then the activation (Dense -> LayerNorm -> act)."""
    if norm is None:
        return act(x)
    if act is torch.tanh:
        return layer_norm_tanh(x, norm.weight, norm.bias)
    return act(norm(x))


def _layer_norms(hidden_dims: Sequence[int], n_act: int, use_layer_norm: bool):
    if not use_layer_norm:
        return None
    return nn.ModuleList(nn.LayerNorm(d, eps=LAYER_NORM_EPS) for d in hidden_dims[:n_act])


class MLP(nn.Module):
    """Dense stack with optional LayerNorm, in the reference order
    Dense -> LayerNorm -> activation. (The JAX module's dropout has no caller
    and is not ported.)"""

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        activations: Union[str, Callable] = "swish",
        activate_final: bool = False,
        use_layer_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = resolve_activation(activations)
        self.activate_final = activate_final
        sizes = [in_features] + list(hidden_dims)
        self.dense = nn.ModuleList(
            dense(i, o, generator) for i, o in zip(sizes[:-1], sizes[1:])
        )
        n_act = len(hidden_dims) if activate_final else len(hidden_dims) - 1
        self.norms = _layer_norms(hidden_dims, n_act, use_layer_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.dense)
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i + 1 < n or self.activate_final:
                x = _norm_act(x, None if self.norms is None else self.norms[i], self.act)
        return x


class EnsembleDense(nn.Module):
    """Dense layer with a leading ensemble axis: (E, in, out) kernel, (E, out)
    bias. Input (..., in) shared across members, or (E, ..., in) per member;
    output (E, ..., out)."""

    def __init__(self, ensemble_size: int, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ensemble_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(ensemble_size, features))
        # per-member xavier, as flax's stacked init
        xavier_uniform_(self.kernel, in_features, features, generator)

    def forward(self, x: torch.Tensor, member_inputs: bool = False) -> torch.Tensor:
        E, _, out = self.kernel.shape
        lead = x.shape[1:-1] if member_inputs else x.shape[:-1]
        if member_inputs:
            y = torch.bmm(x.reshape(E, -1, x.shape[-1]), self.kernel)
        else:
            y = torch.matmul(x.reshape(1, -1, x.shape[-1]), self.kernel)
        y = y + self.bias[:, None, :]
        return y.reshape((E,) + tuple(lead) + (out,))


class EnsembleMLP(nn.Module):
    """MLP with a leading ensemble axis on every kernel; one LayerNorm per
    layer shared by all members. Returns (E, ..., hidden[-1]) features."""

    def __init__(
        self,
        ensemble_size: int,
        in_features: int,
        hidden_dims: Sequence[int],
        activations: Union[str, Callable] = "swish",
        activate_final: bool = False,
        use_layer_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = resolve_activation(activations)
        self.activate_final = activate_final
        sizes = [in_features] + list(hidden_dims)
        self.dense = nn.ModuleList(
            EnsembleDense(ensemble_size, i, o, generator=generator)
            for i, o in zip(sizes[:-1], sizes[1:])
        )
        n_act = len(hidden_dims) if activate_final else len(hidden_dims) - 1
        self.norms = _layer_norms(hidden_dims, n_act, use_layer_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.dense)
        for i, layer in enumerate(self.dense):
            x = layer(x, member_inputs=i > 0)
            if i + 1 < n or self.activate_final:
                x = _norm_act(x, None if self.norms is None else self.norms[i], self.act)
        return x
