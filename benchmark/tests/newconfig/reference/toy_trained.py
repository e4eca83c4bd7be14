"""`toy_trained`'s encoder for the reference: a ResNet-10 trained end to end
(the program's encoder_type "resnet") under the learned-embedding head.

The backbone's parameters are the learner's own, so every pass computes it
from them with autograd and the critic's gradient reaches them; nothing is
frozen and nothing is loaded. Stated precision: bfloat16 convolutions of
float32 parameters, float32 GroupNorm(4), the products of the head and MLPs
in float32 with TF32 off. The control: float8 (e4m3, one scale per tensor)
convolution inputs and weights, TF32 products.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.drq import bottleneck, dropout, learned_embeddings

GN_EPS = 1e-5
GN_GROUPS = 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Precision(NamedTuple):
    tf32_products: bool = False
    convs: str = "bf16"  # or "fp8"


STATED = Precision()
CONTROL = Precision(tf32_products=True, convs="fp8")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())


def _same(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, prec: Precision, pad=None) -> torch.Tensor:
    """A bias-free convolution in bfloat16 (or float8 inputs), flax "SAME"
    unless `pad` is given; a float32 result."""
    if pad is None:
        top, bottom = _same(x.shape[-2], w.shape[-1], stride)
        left, right = _same(x.shape[-1], w.shape[-1], stride)
        x, pad = F.pad(x, (left, right, top, bottom)), 0
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec.convs == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, stride=stride, padding=pad).float()


def _gn(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.group_norm(x, GN_GROUPS, p[f"{name}.weight"], p[f"{name}.bias"], GN_EPS)


def resnet_map(img: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
               prec: Precision) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> the (B, 512, h, w) float32 map of ResNet-10's
    basic blocks, from the learner's parameters under `prefix`."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    x = ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, p[f"{prefix}.conv_init.weight"], 2, prec, pad=3), p,
                   f"{prefix}.norm_init"))
    top, bottom = _same(x.shape[-2], 3, 2)
    left, right = _same(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
    for i in range(4):
        b = f"{prefix}.blocks.{i}"
        stride = 1 if i == 0 else 2
        y = F.relu(_gn(_conv(x, p[f"{b}.convs.0.weight"], stride, prec), p, f"{b}.norms.0"))
        y = _gn(_conv(y, p[f"{b}.convs.1.weight"], 1, prec), p, f"{b}.norms.1")
        residual = x
        if f"{b}.conv_proj.weight" in p:
            residual = _gn(_conv(x, p[f"{b}.conv_proj.weight"], stride, prec), p, f"{b}.norm_proj")
        x = F.relu(residual + y)
    return x


class Encoder:
    frozen_map = None  # the backbone trains

    def __init__(self, config: Dict, device):
        pass  # nothing to load

    def start(self, img: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
              prec: Precision, fmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        return learned_embeddings(resnet_map(img, params, prefix, prec), params, prefix)

    def finish(self, x: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is not None:
            x = dropout(x, mask)
        return bottleneck(x, params, prefix)
