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
biases; lecun-normal for `MLPResNetBlock`'s Dense layers, which take flax's
default init) from an explicit `torch.Generator`.

Dropout keeps flax's order, Dense -> Dropout -> LayerNorm -> activation, and
acts only with `train=True`; then every activated layer's keep-mask (its
output's shape) comes from the caller (`dropout=`, a list in layer order),
and a missing one raises. A layer with dropout runs its
Dense, LayerNorm and tanh as separate ops: the dropout sits between the
Dense and the LayerNorm, so K5 does not apply there.

`MLPResNet` is the pre-norm residual MLP: Dense(hidden), then blocks of
Dropout -> LayerNorm -> Dense(4 hidden) -> act -> Dense(hidden) plus the
residual (projected by a Dense where its width differs), then act and the
output Dense.
"""

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS, dense_layer_norm_tanh
from serl_tpu_torch.vision.encoders import dropout as apply_dropout
from serl_tpu_torch.vision.encoders import lecun_dense

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


def _layer(x, dense_fn, weights, norm, act, rate, train, mask, member_inputs=None):
    """One activated layer, Dense -> Dropout -> LayerNorm -> act: through K5
    where it is LayerNorm + tanh with no dropout acting, else as plain ops."""
    kw = {} if member_inputs is None else {"member_inputs": member_inputs}
    drops = bool(train and rate)
    if norm is not None and act is torch.tanh and not drops:
        return dense_layer_norm_tanh(x, *weights, norm.weight, norm.bias, **kw)
    h = dense_fn(x, **kw)
    if drops:
        h = apply_dropout(h, train, mask, rate)
    return _norm_act(h, norm, act)


class MLP(nn.Module):
    """Dense stack with optional dropout and LayerNorm, in the reference order
    Dense -> Dropout -> LayerNorm -> activation."""

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        activations: Union[str, Callable] = "swish",
        activate_final: bool = False,
        use_layer_norm: bool = False,
        dropout_rate: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = resolve_activation(activations)
        self.dropout_rate = dropout_rate or 0.0
        sizes = [in_features] + list(hidden_dims)
        self.dense = nn.ModuleList(
            dense(i, o, generator) for i, o in zip(sizes[:-1], sizes[1:])
        )
        self.n_act = len(hidden_dims) if activate_final else len(hidden_dims) - 1
        self.norms = _layer_norms(hidden_dims, self.n_act, use_layer_norm)

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            if i >= self.n_act:
                x = layer(x)
                continue
            x = _layer(x, layer, (layer.weight, layer.bias),
                       None if self.norms is None else self.norms[i], self.act,
                       self.dropout_rate, train, dropout[i] if dropout else None)
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
    layer shared by all members. Returns (E, ..., hidden[-1]) features.
    Dropout as `MLP`'s, its masks of the layers' (E, ..., d) outputs."""

    def __init__(
        self,
        ensemble_size: int,
        in_features: int,
        hidden_dims: Sequence[int],
        activations: Union[str, Callable] = "swish",
        activate_final: bool = False,
        use_layer_norm: bool = False,
        dropout_rate: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.act = resolve_activation(activations)
        self.dropout_rate = dropout_rate or 0.0
        sizes = [in_features] + list(hidden_dims)
        self.dense = nn.ModuleList(
            EnsembleDense(ensemble_size, i, o, generator=generator)
            for i, o in zip(sizes[:-1], sizes[1:])
        )
        self.n_act = len(hidden_dims) if activate_final else len(hidden_dims) - 1
        self.norms = _layer_norms(hidden_dims, self.n_act, use_layer_norm)

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            if i >= self.n_act:
                x = layer(x, member_inputs=i > 0)
                continue
            x = _layer(x, layer, (layer.kernel, layer.bias),
                       None if self.norms is None else self.norms[i], self.act,
                       self.dropout_rate, train, dropout[i] if dropout else None,
                       member_inputs=i > 0)
        return x


class MLPResNetBlock(nn.Module):
    """Pre-norm residual block: Dropout -> LayerNorm -> Dense(4 features) ->
    act -> Dense(features), plus the residual, projected by a Dense where the
    input's width differs (flax names Dense_0, Dense_1, Dense_2 for the
    projection, LayerNorm_0; lecun-normal kernels, flax's default)."""

    def __init__(self, in_features: int, features: int, act: Union[str, Callable] = "swish",
                 dropout_rate: Optional[float] = None, use_layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = resolve_activation(act)
        self.dropout_rate = dropout_rate or 0.0
        self.norm = nn.LayerNorm(in_features, eps=LAYER_NORM_EPS) if use_layer_norm else None
        self.up = lecun_dense(in_features, 4 * features, generator)
        self.down = lecun_dense(4 * features, features, generator)
        self.proj = lecun_dense(in_features, features, generator) if in_features != features \
            else None

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x
        if self.dropout_rate:
            x = apply_dropout(x, train, dropout, self.dropout_rate)
        if self.norm is not None:
            x = self.norm(x)
        x = self.down(self.act(self.up(x)))
        if self.proj is not None:
            residual = self.proj(residual)
        return residual + x


class MLPResNet(nn.Module):
    """Residual MLP: Dense(hidden_dim) (xavier), `num_blocks` blocks, act,
    Dense(out_dim) (xavier). Dropout masks, one per block of (..., hidden_dim),
    as `dropout=` in train mode."""

    def __init__(self, in_features: int, num_blocks: int, out_dim: int,
                 dropout_rate: Optional[float] = None, use_layer_norm: bool = False,
                 hidden_dim: int = 256, activations: Union[str, Callable] = "swish",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = resolve_activation(activations)
        self.inp = dense(in_features, hidden_dim, generator)
        self.blocks = nn.ModuleList(
            MLPResNetBlock(hidden_dim, hidden_dim, self.act, dropout_rate, use_layer_norm,
                           generator) for _ in range(num_blocks))
        self.out = dense(hidden_dim, out_dim, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        x = self.inp(x)
        for i, block in enumerate(self.blocks):
            x = block(x, train, dropout[i] if dropout else None)
        return self.out(self.act(x))
