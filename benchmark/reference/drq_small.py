"""`drq_small`'s encoder for the reference: SERL's SmallEncoder per camera.

Stated precision: the convolutions in bfloat16 (inputs, weights and bias
cast, relu in bfloat16, then float32 pooling), the products of the MLPs,
heads and bottleneck in float32 with TF32 off. The control lowers each one
step: float8 (e4m3, one scale per tensor) inputs and weights of the
convolutions, TF32 products. Nothing is frozen and nothing is loaded; the
bottleneck belongs to the start, and there is no dropout.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.drq import bottleneck


class Precision(NamedTuple):
    """tf32_products: the MLPs', heads' and bottleneck's products in TF32.
    small_convs: "bf16" or "fp8" convolutions of the small encoder."""

    tf32_products: bool = False
    small_convs: str = "bf16"


STATED = Precision()
CONTROL = Precision(tf32_products=True, small_convs="fp8")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor; the
    gradient passes to x as it is, and the convolution's own gradients read
    the rounded values, as an fp8 convolution's would."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())


def small_encoder(img: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
                  prec: Precision) -> torch.Tensor:
    """SERL's SmallEncoder: 4 x (3x3 stride-2 VALID conv, relu) in bfloat16,
    then the spatial mean and the 256-wide bottleneck."""
    x = (img.to(torch.bfloat16) / 255.0).permute(0, 3, 1, 2)
    for i in range(4):
        w = p[f"{prefix}.convs.{i}.weight"].to(torch.bfloat16)
        b = p[f"{prefix}.convs.{i}.bias"].to(torch.bfloat16)
        if prec.small_convs == "fp8":
            x, w = _fp8(x), _fp8(w)
        x = F.relu(F.conv2d(x, w, b, stride=2))
    x = x.float().mean(dim=(-2, -1))
    return bottleneck(x, p, prefix)


class Encoder:
    """One camera's SmallEncoder, its bottleneck included."""

    frozen_map = None  # nothing is frozen

    def __init__(self, config: Dict, device):
        pass  # nothing to load

    def start(self, img: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
              prec: Precision, fmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        return small_encoder(img, params, prefix, prec)

    def finish(self, x: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        return x
