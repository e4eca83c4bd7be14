"""`drq_resnet50`'s encoder for the reference: ResNet-v1-50 with GroupNorm,
trained end to end, under the learned-embedding head, per camera.

The backbone is SERL's `resnetv1_configs["resnetv1-50"]`
(`serl_launcher/vision/resnet_v1.py`): ImageNet normalisation, a 7x7
stride-2 stem padded (3, 3), GroupNorm(4), relu, a 3x3 stride-2 "SAME"
max-pool, then stages of 3, 4, 6 and 3 bottleneck blocks of inner widths 64,
128, 256 and 512. A block is conv 1x1 -> norm -> relu -> conv 3x3 (the
stage's stride, on the first block of every stage after the first) -> norm
-> relu -> conv 1x1 to 4x the width -> norm, plus the residual, projected by
a strided 1x1 convolution and a norm where its shape changes (the first
block of every stage), then relu. The map (2048 channels) goes to SERL
DrQ's `encoder_type="resnet"` head: SpatialLearnedEmbeddings (8 features),
dropout, the 256-wide Dense -> LayerNorm -> tanh bottleneck.

The backbone's parameters are the learner's own, so every pass computes it
from them with autograd and the critic's gradient reaches them; nothing is
frozen and nothing is loaded. Stated precision: bfloat16 convolutions of
float32 parameters (each convolution's input and weight cast, a bfloat16
result read back as float32), float32 GroupNorm, the products of the head
and MLPs in float32 with TF32 off. The control lowers each one step: float8
(e4m3, one scale per tensor) convolution inputs and weights, TF32 products.

Departures from the published description: none in the arithmetic. flax's
"SAME" padding puts the odd pixel after (a stride-2 3x3 convolution or
max-pool on an even map pads (0, 1)), as SERL's does. The published
initialisation sets each bottleneck block's last GroupNorm scale to 0; the
benchmark writes every scale as 1 instead (its weights, not this file's).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.drq import bottleneck, dropout, learned_embeddings

GN_EPS = 1e-5
GN_GROUPS = 4
EXPANSION = 4  # a bottleneck block's output channels over its inner width
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Precision(NamedTuple):
    """tf32_products: the MLPs', heads' and bottleneck's products in TF32.
    convs: "bf16" or "fp8" inputs and weights of the backbone's convolutions
    ("fp32": float32 convolutions, for a test of the arithmetic alone)."""

    tf32_products: bool = False
    convs: str = "bf16"


STATED = Precision()
CONTROL = Precision(tf32_products=True, convs="fp8")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor; the
    gradient passes to x as it is, and the convolution's own gradients read
    the rounded values, as an fp8 convolution's would."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x.detach())


def _same(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, prec: Precision, pad=None) -> torch.Tensor:
    """A bias-free convolution in `prec.convs`, flax "SAME" unless `pad` is
    given; a float32 result."""
    if pad is None:
        top, bottom = _same(x.shape[-2], w.shape[-1], stride)
        left, right = _same(x.shape[-1], w.shape[-1], stride)
        x, pad = F.pad(x, (left, right, top, bottom)), 0
    if prec.convs == "fp32":
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(x, w, stride=stride, padding=pad)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if prec.convs == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, stride=stride, padding=pad).float()


def _gn(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return F.group_norm(x, GN_GROUPS, p[f"{name}.weight"], p[f"{name}.bias"], GN_EPS)


def resnet50_map(img: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, stages, widths,
                 prec: Precision) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> the (B, 2048, h, w) float32 map of ResNet-v1-50's
    bottleneck blocks, from the learner's parameters under `prefix`."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    x = ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, p[f"{prefix}.conv_init.weight"], 2, prec, pad=3), p,
                   f"{prefix}.norm_init"))
    top, bottom = _same(x.shape[-2], 3, 2)
    left, right = _same(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
    i = 0
    for stage, (blocks, width) in enumerate(zip(stages, widths)):
        for j in range(blocks):
            b = f"{prefix}.blocks.{i}"
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(_gn(_conv(x, p[f"{b}.convs.0.weight"], 1, prec), p, f"{b}.norms.0"))
            y = F.relu(_gn(_conv(y, p[f"{b}.convs.1.weight"], stride, prec), p, f"{b}.norms.1"))
            y = _gn(_conv(y, p[f"{b}.convs.2.weight"], 1, prec), p, f"{b}.norms.2")
            residual = x
            if j == 0:  # the block's output differs from its input in channels or size
                residual = _gn(_conv(x, p[f"{b}.conv_proj.weight"], stride, prec), p,
                               f"{b}.norm_proj")
            x = F.relu(residual + y)
            i += 1
    assert x.shape[1] == EXPANSION * widths[-1], x.shape
    return x


class Encoder:
    """One camera's trained ResNet-v1-50 and its head."""

    frozen_map = None  # the backbone trains

    def __init__(self, config: Dict, device):
        enc = config["encoder"]
        self.stages, self.widths = tuple(enc["stage_sizes"]), tuple(enc["widths"])

    def start(self, img: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
              prec: Precision, fmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        fmap = resnet50_map(img, params, prefix, self.stages, self.widths, prec)
        return learned_embeddings(fmap, params, prefix)

    def finish(self, x: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is not None:
            x = dropout(x, mask)
        return bottleneck(x, params, prefix)
