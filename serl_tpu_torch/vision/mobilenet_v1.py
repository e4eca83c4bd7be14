"""MobileNetV1 backbone and the TF-slim checkpoint import.

Port of `serl_tpu/vision/mobilenet_v1.py`: the standard MobileNetV1 feature
extractor (a 3x3 stride-2 stem and 13 depthwise-separable blocks, relu6,
width multiplier; no classifier) with every BatchNorm folded to a frozen
per-channel affine (`FoldedBN`: y = x * scale + bias), and
`load_tf_slim_params`, which turns the TF-slim names every public
MobileNetV1 checkpoint ships in (`MobilenetV1/Conv2d_0/weights`,
`Conv2d_<k>_depthwise/depthwise_weights`, `Conv2d_<k>_pointwise/weights`,
BatchNorm gamma, beta, moving_mean, moving_variance; an .npz or pickle of
name -> array, with or without the `MobilenetV1/` prefix) into the JAX
module's param tree, as numpy arrays: {"conv0": {"kernel"}, "conv0_bn":
{"scale", "bias"}, "conv<i>_dw", "conv<i>_dw_bn", "conv<i>_pw",
"conv<i>_pw_bn"}. The folding uses eps 1e-3; `FoldedBN` only scales and
shifts. TF's conv kernels are (H, W, in, out) like flax's; a depthwise
kernel (H, W, C, 1) becomes flax's grouped (H, W, 1, C), and here torch's
(C, 1, H, W) (`MobileNetV1.load_params`).

Layout: the module takes NHWC float images and returns the NHWC map
(ceil(H / 32), ceil(W / 32), 1024 * width); inside, NCHW views with
channels_last strides, convolutions through cuDNN (the depthwise ones with
groups = C), flax's "SAME" padding (`same_pads`: a stride-2 3x3 on an even
input pads (0, 1)), fp32 on cuDNN's TF32 path on the card as the ResNet's
(`encoders._tf32_convs`).

No ImageNet checkpoint is in the repository, and none is fetched: the
loader is held on a synthetic name -> array dict made from a seed.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.vision.encoders import _tf32_convs, conv2d_same, lecun_normal_

# (pointwise_channels, stride) per depthwise-separable block: the standard V1
BLOCKS: Sequence[Tuple[int, int]] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
)
BN_EPS = 1e-3  # TF-slim's BatchNorm epsilon, folded in by the loader


def channels(ch: int, width: float) -> int:
    return max(8, int(ch * width))


class FoldedBN(nn.Module):
    """Frozen inference BatchNorm as a per-channel affine: x * scale + bias
    (ones and zeros at init; the loader folds a checkpoint's statistics in)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x (B, C, H, W)
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, groups: int = 1, generator=None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, groups=groups, bias=False)
    lecun_normal_(conv.weight, cin // groups * k * k, generator)  # flax's default
    return conv


class MobileNetV1(nn.Module):
    """MobileNetV1 feature extractor on (B, H, W, 3) float images of
    `image_size`; `feature_shape` is its (h, w, c) map. Submodules carry
    flax's names: conv0, conv0_bn, conv<i>_dw, conv<i>_dw_bn, conv<i>_pw,
    conv<i>_pw_bn for i in 1..13."""

    def __init__(self, width: float = 1.0, image_size=224,
                 generator: torch.Generator = None):
        super().__init__()
        h, w = (image_size, image_size) if isinstance(image_size, int) else tuple(image_size)
        c = channels(32, width)
        layers = {"conv0": _conv(3, c, 3, generator=generator), "conv0_bn": FoldedBN(c)}
        h, w = -(-h // 2), -(-w // 2)
        self.strides = []
        for i, (ch, stride) in enumerate(BLOCKS, start=1):
            out = channels(ch, width)
            layers[f"conv{i}_dw"] = _conv(c, c, 3, groups=c, generator=generator)
            layers[f"conv{i}_dw_bn"] = FoldedBN(c)
            layers[f"conv{i}_pw"] = _conv(c, out, 1, generator=generator)
            layers[f"conv{i}_pw_bn"] = FoldedBN(out)
            self.strides.append(stride)
            h, w, c = -(-h // stride), -(-w // stride), out
        self.layers = nn.ModuleDict(layers)
        self.feature_shape = (h, w, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # an NCHW view of the NHWC images
        L = self.layers
        with _tf32_convs(x.device, x.dtype):
            x = F.relu6(L["conv0_bn"](conv2d_same(x, L["conv0"].weight, 2)))
            for i, stride in enumerate(self.strides, start=1):
                dw = L[f"conv{i}_dw"].weight
                x = F.relu6(L[f"conv{i}_dw_bn"](conv2d_same(x, dw, stride, groups=dw.shape[0])))
                x = F.relu6(L[f"conv{i}_pw_bn"](F.conv2d(x, L[f"conv{i}_pw"].weight)))
        return x.permute(0, 2, 3, 1)

    def param_pairs(self):
        """(flax path, tensor, layout) of every tensor: kernels "HWIO" (flax
        (H, W, in, out), or (H, W, 1, C) for a depthwise one, to torch's
        (out, in / groups, H, W)), the affines as they are."""
        out = []
        for name, module in self.layers.items():
            if isinstance(module, FoldedBN):
                out += [((name, "scale"), module.scale, None), ((name, "bias"), module.bias, None)]
            else:
                out.append(((name, "kernel"), module.weight, "HWIO"))
        return out

    @torch.no_grad()
    def load_params(self, params: Dict) -> "MobileNetV1":
        """Copy a flax-layout tree (numpy or arrays; `load_tf_slim_params`'
        output) into the module, checking every shape (in place)."""
        for (name, leaf), tensor, layout in self.param_pairs():
            value = torch.from_numpy(np.array(params[name][leaf], np.float32))
            if layout == "HWIO":
                value = value.permute(3, 2, 0, 1)
            if value.shape != tensor.shape:
                raise ValueError(f"{name}/{leaf}: shape {tuple(value.shape)}, the module "
                                 f"expects {tuple(tensor.shape)}")
            tensor.copy_(value)
        return self


def _fold_bn(weights: Dict[str, np.ndarray], prefix: str, eps: float = BN_EPS) -> Dict:
    gamma = np.asarray(weights[f"{prefix}/BatchNorm/gamma"])
    beta = np.asarray(weights[f"{prefix}/BatchNorm/beta"])
    mean = np.asarray(weights[f"{prefix}/BatchNorm/moving_mean"])
    var = np.asarray(weights[f"{prefix}/BatchNorm/moving_variance"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def load_tf_slim_params(path_or_dict: Any, width: float = 1.0) -> Dict:
    """A TF-slim MobileNetV1 checkpoint (name -> array; an .npz or pickle
    path, or a loaded dict) -> the flax param tree of `MobileNetV1(width)`
    as numpy arrays (the module docstring)."""
    if isinstance(path_or_dict, dict):
        w = path_or_dict
    elif str(path_or_dict).endswith(".npz"):
        w = dict(np.load(path_or_dict))
    else:
        with open(path_or_dict, "rb") as f:
            w = pickle.load(f)
    if not any(k.startswith("MobilenetV1/") for k in w):
        w = {f"MobilenetV1/{k}": v for k, v in w.items()}
    params: Dict[str, Any] = {
        "conv0": {"kernel": np.asarray(w["MobilenetV1/Conv2d_0/weights"])},
        "conv0_bn": _fold_bn(w, "MobilenetV1/Conv2d_0"),
    }
    for i in range(1, len(BLOCKS) + 1):
        dw = np.asarray(w[f"MobilenetV1/Conv2d_{i}_depthwise/depthwise_weights"])
        params[f"conv{i}_dw"] = {"kernel": np.transpose(dw, (0, 1, 3, 2))}  # (H, W, 1, C)
        params[f"conv{i}_dw_bn"] = _fold_bn(w, f"MobilenetV1/Conv2d_{i}_depthwise")
        params[f"conv{i}_pw"] = {"kernel": np.asarray(w[f"MobilenetV1/Conv2d_{i}_pointwise/weights"])}
        params[f"conv{i}_pw_bn"] = _fold_bn(w, f"MobilenetV1/Conv2d_{i}_pointwise")
    return params


def make_mobilenet_encoder(params: Dict, width: float = 1.0, image_size=224,
                           generator: torch.Generator = None, **encoder_kwargs):
    """A frozen MobileNetV1 with `params` (a flax-layout tree) under a
    trainable pooling head: the JAX package's MobileNetEncoder assembled end
    to end. `encoder_kwargs` go to FrozenBackboneEncoder."""
    from serl_tpu_torch.vision.mobilenet import FrozenBackboneEncoder

    backbone = MobileNetV1(width, image_size, generator).load_params(params)
    return FrozenBackboneEncoder(backbone, generator=generator, **encoder_kwargs)
