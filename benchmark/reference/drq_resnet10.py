"""`drq_resnet10`'s encoder for the reference: the frozen ResNet-10 under a
trained learned-embedding head, per camera.

The backbone (stages 1-1-1-1, widths 64-512, GroupNorm(4)) is read from the
configuration's pickle by `resnet10.load`, in float32 parameters with TF32
convolutions and float32 GroupNorm; it is frozen, so its map of a frame is
computed once per update (`frozen_map`). The head: SERL's
SpatialLearnedEmbeddings (8 features), dropout, then the 256-wide
bottleneck; products in float32 with TF32 off. The control lowers each one
step: bfloat16 backbone convolutions, TF32 products.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import resnet10
from benchmark.reference.drq import bottleneck, dropout, learned_embeddings

GN_EPS = 1e-5  # the ResNet's GroupNorm
GN_GROUPS = 4
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Precision(NamedTuple):
    """tf32_products: the MLPs', heads' and bottleneck's products in TF32.
    backbone: "tf32" or "bf16" convolutions of the frozen ResNet-10."""

    tf32_products: bool = False
    backbone: str = "tf32"


STATED = Precision()
CONTROL = Precision(tf32_products=True, backbone="bf16")


def _same(size: int, k: int, s: int):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int, prec: Precision) -> torch.Tensor:
    """flax "SAME" convolution (the odd pad after) in the backbone's precision."""
    top, bottom = _same(x.shape[-2], w.shape[-1], stride)
    left, right = _same(x.shape[-1], w.shape[-1], stride)
    x = F.pad(x, (left, right, top, bottom))
    if prec.backbone == "bf16":
        return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        return F.conv2d(x, w, stride=stride)


def resnet10_map(img: torch.Tensor, bb: Dict[str, torch.Tensor], prec: Precision) -> torch.Tensor:
    """The frozen ResNet-10 (stages 1-1-1-1, widths 64-512, GroupNorm(4)):
    (B, H, W, 3) uint8 -> the (B, 512, h, w) float32 map."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    x = ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    w = bb["conv_init"]
    if prec.backbone == "bf16":
        x = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=2, padding=3).float()
    else:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            x = F.conv2d(x, w, stride=2, padding=3)
    x = F.relu(F.group_norm(x, GN_GROUPS, bb["norm_init.scale"], bb["norm_init.bias"], GN_EPS))
    top, bottom = _same(x.shape[-2], 3, 2)
    left, right = _same(x.shape[-1], 3, 2)
    x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), 3, 2)
    for i in range(4):
        blk = f"block{i}"
        stride = 1 if i == 0 else 2
        y = _conv_same(x, bb[f"{blk}.conv0"], stride, prec)
        y = F.relu(F.group_norm(y, GN_GROUPS, bb[f"{blk}.gn0.scale"], bb[f"{blk}.gn0.bias"], GN_EPS))
        y = _conv_same(y, bb[f"{blk}.conv1"], 1, prec)
        y = F.group_norm(y, GN_GROUPS, bb[f"{blk}.gn1.scale"], bb[f"{blk}.gn1.bias"], GN_EPS)
        residual = x
        if f"{blk}.proj" in bb:
            residual = F.group_norm(_conv_same(x, bb[f"{blk}.proj"], stride, prec), GN_GROUPS,
                                    bb[f"{blk}.proj_norm.scale"], bb[f"{blk}.proj_norm.bias"],
                                    GN_EPS)
        x = F.relu(residual + y)
    return x


class Encoder:
    """One camera's frozen ResNet-10 and trained head."""

    def __init__(self, config: Dict, device):
        self.backbone = resnet10.load(config["encoder"]["weights"], device=device)

    def frozen_map(self, img: torch.Tensor, prec: Precision) -> torch.Tensor:
        return resnet10_map(img, self.backbone, prec)

    def start(self, img: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
              prec: Precision, fmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The learned embeddings of the backbone's map (`fmap`, where the
        caller has it)."""
        if fmap is None:
            fmap = self.frozen_map(img, prec)
        return learned_embeddings(fmap, params, prefix)

    def finish(self, x: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is not None:
            x = dropout(x, mask)
        return bottleneck(x, params, prefix)
