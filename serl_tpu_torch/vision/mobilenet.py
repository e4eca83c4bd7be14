"""Frozen-backbone encoder (MobileNet-style).

Port of `serl_tpu/vision/mobilenet.py`: images / 255, ImageNet
normalisation, a frozen backbone (NHWC images -> NHWC feature map) run under
no_grad (JAX's stop_gradient), then the trainable pooling head and the
Dense -> LayerNorm -> tanh bottleneck (K5) of `vision/encoders.py`.

In the JAX package the backbone's params live in the module's closure, not
in its param tree, so no optimizer holds them. Here the backbone is a
submodule whose tensors are turned into buffers (`freeze`): they move with
`.to()`, sit in the state dict, and no optimizer holds them or gradient
reaches them. `encode=False` takes a given (B, h, w, c) map and runs the
head alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from serl_tpu_torch.vision.encoders import IMAGENET_MEAN, IMAGENET_STD, Bottleneck, Pool


def freeze(module: nn.Module) -> nn.Module:
    """Every parameter of `module` becomes a buffer of the same name (in place)."""
    for m in module.modules():
        for name, p in list(m._parameters.items()):
            if p is not None:
                del m._parameters[name]
                m.register_buffer(name, p.detach())
    return module


class FrozenBackboneEncoder(nn.Module):
    """`backbone` (NHWC float images -> NHWC map; its `feature_shape` the
    map's (h, w, c)) frozen, then a trainable pooling head."""

    def __init__(self, backbone: nn.Module, pooling_method: str = "spatial_learned_embeddings",
                 num_spatial_blocks: int = 8, bottleneck_dim: Optional[int] = 256,
                 normalize_imagenet: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = freeze(backbone)
        self.normalize_imagenet = normalize_imagenet
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        h, w, c = backbone.feature_shape
        self.pool = Pool(pooling_method, (c, h, w), num_spatial_blocks, generator)
        self.dropout_features = self.pool.dropout_features
        self.out_features = self.pool.out_features
        self.bottleneck = None
        if bottleneck_dim is not None:
            self.bottleneck = Bottleneck(self.out_features, bottleneck_dim, generator)
            self.out_features = bottleneck_dim

    def forward(self, observations: torch.Tensor, train: bool = False,
                dropout: Optional[torch.Tensor] = None, encode: bool = True) -> torch.Tensor:
        x = observations
        if encode:
            with torch.no_grad():
                x = x.to(torch.float32) / 255.0
                if self.normalize_imagenet:
                    x = (x - self.mean) / self.std
                x = self.backbone(x)
        x = self.pool(x.permute(0, 3, 1, 2), train, dropout)
        return x if self.bottleneck is None else self.bottleneck(x)


MobileNetEncoder = FrozenBackboneEncoder  # the JAX package's alias
