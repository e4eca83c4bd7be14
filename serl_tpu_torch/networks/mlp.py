"""MLP family, including a batched ensemble MLP.

Port of `serl_tpu/networks/mlp.py` (MLP, EnsembleDense, EnsembleMLP). The
ensemble is a leading axis on the weights: `EnsembleDense` keeps the JAX
package's (E, in, out) kernel layout and contracts it with one batched
matmul. Two flax conventions are kept on purpose:
  * LayerNorm epsilon is flax's 1e-6, not torch's 1e-5;
  * `EnsembleMLP` has ONE LayerNorm per layer, shared by all members.
A Dense followed by LayerNorm and tanh goes through K5,
`dense_layer_norm_tanh` (one autograd op; a CUDA kernel on the card), which
reads the Dense's and the `nn.LayerNorm`'s parameters where they are. Any
other activation, and the Dense of a layer without one, runs as plain torch
ops: it is another function, not a fallback.
Weights are initialized like flax's defaults (xavier-uniform kernels, zero
biases) from an explicit `torch.Generator`.
"""

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS, dense_layer_norm_tanh

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
    return act(x) if norm is None else act(norm(x))


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
            if i + 1 == n and not self.activate_final:
                x = layer(x)
            elif self.norms is not None and self.act is torch.tanh:
                norm = self.norms[i]
                x = dense_layer_norm_tanh(x, layer.weight, layer.bias, norm.weight, norm.bias)
            else:
                x = _norm_act(layer(x), None if self.norms is None else self.norms[i], self.act)
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
            if i + 1 == n and not self.activate_final:
                x = layer(x, member_inputs=i > 0)
            elif self.norms is not None and self.act is torch.tanh:
                norm = self.norms[i]
                x = dense_layer_norm_tanh(x, layer.kernel, layer.bias, norm.weight, norm.bias,
                                          member_inputs=i > 0)
            else:
                x = _norm_act(layer(x, member_inputs=i > 0),
                              None if self.norms is None else self.norms[i], self.act)
        return x
