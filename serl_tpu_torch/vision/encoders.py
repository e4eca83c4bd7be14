"""Vision encoders: the DrQ SmallEncoder, its pooling and bottleneck.

Port of `SmallEncoder`, `_pool` and `_bottleneck` from
`serl_tpu/vision/encoders.py`. The public functions keep the JAX package's
NHWC layout: an encoder takes (B, H, W, C) images. Inside, the images are
viewed as NCHW with channels_last strides (no copy) and the convolutions are
`nn.Conv2d` weights run through cuDNN, in `compute_dtype` (bf16 on the DrQ
path) with fp32 params, as flax's `nn.Conv(dtype=bfloat16)` does. The
pooling and the bottleneck run in fp32; the bottleneck's Dense -> LayerNorm
-> tanh is K5 (`networks/dense_layer_norm_tanh.py`, flax's eps 1e-6).

Weights are initialised as flax does, from an explicit `torch.Generator`:
lecun_normal (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in) for the conv and dense kernels, zero biases.

Not ported yet, and raising: the ResNet encoders, the pretrained ResNet,
the `spatial_learned_embeddings` and `spatial_softmax` pooling, and padding
other than "VALID". The MXU-stem ablations `pad_input_channels` and
`space_to_depth_stem` have no caller on the path and are left out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS, dense_layer_norm_tanh

# stddev of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_dense(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """nn.Linear initialised like flax's default Dense (lecun_normal, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def _pool(x: torch.Tensor, method: str) -> torch.Tensor:
    """x: (B, C, H, W) fp32 -> (B, C) for "avg"/"max", (B, H, W, C) for "none"."""
    if method == "avg":
        return x.mean(dim=(-2, -1))
    if method == "max":
        return x.amax(dim=(-2, -1))
    if method == "none":
        return x.permute(0, 2, 3, 1)
    if method in ("spatial_learned_embeddings", "spatial_softmax"):
        raise NotImplementedError(f"{method} pooling is not ported yet (the ResNet encoders)")
    raise ValueError(f"unknown pooling method {method}")


class Bottleneck(nn.Module):
    """Dense -> LayerNorm -> tanh (serl_tpu's `_bottleneck`)."""

    def __init__(self, in_features: int, dim: int, generator=None):
        super().__init__()
        self.dense = lecun_dense(in_features, dim, generator)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_layer_norm_tanh(x, self.dense.weight, self.dense.bias, self.norm.weight,
                                     self.norm.bias)


class SmallEncoder(nn.Module):
    """4-conv encoder: x / 255 in `compute_dtype`, Conv + relu per feature
    size, then fp32 pooling and an optional Dense -> LayerNorm -> tanh
    bottleneck. Input (B, H, W, in_channels); `in_channels` is the image's
    channels times the frame stack."""

    def __init__(
        self,
        in_channels: int = 3,
        features: Sequence[int] = (32, 64, 128, 256),
        kernel_sizes: Sequence[int] = (3, 3, 3, 3),
        strides: Sequence[int] = (2, 2, 2, 2),
        padding: str = "VALID",
        pool_method: str = "avg",
        bottleneck_dim: Optional[int] = 256,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if padding != "VALID":
            raise NotImplementedError(f"padding {padding!r} is not ported yet (only 'VALID')")
        _pool(torch.zeros(1, 1, 1, 1), pool_method)  # raises for an unported method
        self.pool_method = pool_method
        self.compute_dtype = compute_dtype
        self.strides = tuple(strides)
        sizes = [in_channels] + list(features)
        self.convs = nn.ModuleList()
        for cin, cout, k in zip(sizes[:-1], sizes[1:], kernel_sizes):
            conv = nn.Conv2d(cin, cout, k, bias=True)
            lecun_normal_(conv.weight, cin * k * k, generator)
            with torch.no_grad():
                conv.bias.zero_()
            self.convs.append(conv)
        self.bottleneck = (None if bottleneck_dim is None
                           else Bottleneck(features[-1], bottleneck_dim, generator))
        self.out_features = features[-1] if bottleneck_dim is None else bottleneck_dim

    def forward(self, observations: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        # NHWC -> an NCHW view with channels_last strides
        x = (observations.to(cd) / 255.0).permute(0, 3, 1, 2)
        for conv, stride in zip(self.convs, self.strides):
            w = conv.weight.to(dtype=cd, memory_format=torch.channels_last)
            x = F.relu(F.conv2d(x, w, conv.bias.to(cd), stride=stride))
        x = _pool(x.to(torch.float32), self.pool_method)
        if self.bottleneck is not None:
            x = self.bottleneck(x)
        return x
