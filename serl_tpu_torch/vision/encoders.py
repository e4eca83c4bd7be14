"""Vision encoders: ResNet-v1 (GroupNorm), the SmallEncoder, pooling heads, FiLM.

Port of `serl_tpu/vision/encoders.py`. The public functions keep the JAX
package's NHWC layout: an encoder takes (B, H, W, C) images, and a
`pre_pooling` ResNet returns (B, h, w, c) feature maps. Inside, the images
are viewed as NCHW with channels_last strides (no copy) and the
convolutions run through cuDNN in `compute_dtype` with fp32 params, as
flax's `nn.Conv(dtype=...)` does; the normalisations, the pooling and the
bottleneck run in fp32 (flax's GroupNorm returns fp32 from a bf16 input, so
a bf16 ResNet casts only each convolution's input). The bottleneck's Dense
-> LayerNorm -> tanh is K5 (`networks/dense_layer_norm_tanh.py`, flax's eps
1e-6).

Padding follows flax: "SAME" pads by `same_pads`, which puts the odd pixel
at the end (a stride-2 3x3 convolution or max-pool on an even input pads
(0, 1), not (1, 1)); the ResNet stem's 7x7 convolution pads (3, 3). fp32
convolutions on the card take cuDNN's TF32 tensor-core path inside the
ResNet whatever the global flag says (`_tf32_convs`), as XLA's default
precision does on GPUs; the CPU computes them in fp32.

Dropout (rate 0.1, after `SpatialLearnedEmbeddings`) acts only with
`train=True`, and then takes its keep-mask (B, c * f) from the caller
(`dropout=`): the SAC agent draws it with the rest of an update's draws
from its generator, so a test can feed the JAX package's masks.

Weights are initialised as flax does, from an explicit `torch.Generator`:
truncated normals scaled to variance scale / fan_in (lecun_normal 1,
kaiming_normal 2) for conv, dense and spatial-embedding kernels, zero
biases, GroupNorm scales one (zero for a bottleneck block's last).

Conditioning: a ResNet with `use_film` applies `FilmConditioning` (two
zero-initialised Dense layers of the conditioning vector, so the identity
at init: x * (1 + mult) + add per channel) after every block, and with
`use_multiplicative_cond` multiplies every block's output by a Dense of it
(xavier-normal); the `cond_var` comes with the call (the language-
conditioned encoder passes its goal's embedding). The registry holds
resnetv1-10, -18, -34 and -50 (bottleneck blocks, whose last GroupNorm's
scale starts at zero) and their "-bridge" and "-bridge-film" forms. A head
over a given pre-pooling map (`encode=False`) skips the backbone of
`PreTrainedResNetEncoder`; the SmallEncoder accepts the flag and ignores
it, as the JAX module does.

The SmallEncoder's stem switches `pad_input_channels` and
`space_to_depth_stem` (the levers of `tools/mfu_experiments.py`) are
ported; tests/test_torch_augmentations.py::
test_torch_small_encoder_stem_switches_match_jax holds them against flax.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS, dense_layer_norm_tanh

# stddev of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DROPOUT_RATE = 0.1
RESNET_NORM_EPS = 1e-5


def variance_scaling_(w: torch.Tensor, scale: float, fan: float, generator=None) -> torch.Tensor:
    """flax's truncated-normal variance_scaling: variance scale / fan."""
    std = math.sqrt(scale / fan) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal with variance 1 / fan_in."""
    return variance_scaling_(w, 1.0, fan_in, generator)


def lecun_dense(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """nn.Linear initialised like flax's default Dense (lecun_normal, zero bias)."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's "SAME" padding of one axis: (before, after), the odd one after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same_pad4(x: torch.Tensor, kernel: int, stride: int) -> Tuple[int, int, int, int]:
    (top, bottom), (left, right) = (same_pads(x.shape[-2], kernel, stride),
                                    same_pads(x.shape[-1], kernel, stride))
    return left, right, top, bottom


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int, groups: int = 1,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A convolution of NCHW `x` with "SAME" padding (`groups` as F.conv2d's)."""
    left, right, top, bottom = _same_pad4(x, weight.shape[-1], stride)
    if (left, top) == (right, bottom):
        return F.conv2d(x, weight, bias, stride=stride, padding=(top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride=stride,
                    groups=groups)


def conv_out_size(size: int, kernel: int, stride: int, padding) -> int:
    """One spatial axis after a convolution with flax's `padding`: "SAME",
    "VALID" or an int p (p on both sides)."""
    if padding == "SAME":
        return -(-size // stride)
    p = 0 if padding == "VALID" else int(padding)
    return (size + 2 * p - kernel) // stride + 1


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """flax's `max_pool(x, (k, k), (s, s), "SAME")` on NCHW `x` (-inf pads)."""
    pads = _same_pad4(x, kernel, stride)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def _tf32_convs(device: torch.device, dtype: torch.dtype):
    """Context for fp32 convolutions on the card: cuDNN's TF32 path."""
    if device.type == "cuda" and dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                          benchmark=torch.backends.cudnn.benchmark,
                                          deterministic=torch.backends.cudnn.deterministic,
                                          allow_tf32=True)
    return contextlib.nullcontext()


def dropout(x: torch.Tensor, train: bool, mask: Optional[torch.Tensor] = None,
            rate: float = DROPOUT_RATE) -> torch.Tensor:
    """flax's Dropout(rate): with `train`, x / keep where `mask` (bool, x's
    shape) keeps it, else 0. Every draw is the caller's: in train mode a
    missing mask raises."""
    if not train:
        return x
    if mask is None:
        raise ValueError("dropout in train mode needs its keep-mask (SACAgent.update_draws "
                         "draws one per encoder pass)")
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros_like(x))


_ACTIVATIONS = {"relu": F.relu, "swish": F.silu, "silu": F.silu, "tanh": torch.tanh,
                "elu": F.elu, "gelu": functools.partial(F.gelu, approximate="tanh"),
                "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.01)}


# ---------------------------------------------------------------- pooling heads


class SpatialLearnedEmbeddings(nn.Module):
    """Per-channel learned spatial pooling: out[b, c, f] = sum over (h, w) of
    x[b, c, h, w] * kernel[h, w, c, f], flattened to (B, c * f); the kernel
    keeps flax's (h, w, c, f) layout (lecun_normal, fan_in h * w * c)."""

    def __init__(self, height: int, width: int, channels: int, num_features: int = 8,
                 generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(height, width, channels, num_features))
        lecun_normal_(self.kernel, height * width * channels, generator)
        self.out_features = channels * num_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x (B, C, H, W)
        return torch.einsum("bchw,hwcf->bcf", x, self.kernel).flatten(1)


class SpatialSoftmax(nn.Module):
    """Soft-argmax keypoints (B, 2C): each channel's softmax over its h * w
    positions, the expected x then y. The positions are flax's:
    `meshgrid(linspace(-1, 1, h), linspace(-1, 1, w))` in its "xy" indexing,
    flattened against the row-major (h, w) positions."""

    def __init__(self, height: int, width: int, channels: int, temperature: float = 1.0,
                 learn_temperature: bool = False):
        super().__init__()
        pos_x, pos_y = torch.meshgrid(torch.linspace(-1.0, 1.0, height),
                                      torch.linspace(-1.0, 1.0, width), indexing="xy")
        self.register_buffer("pos_x", pos_x.reshape(-1), persistent=False)
        self.register_buffer("pos_y", pos_y.reshape(-1), persistent=False)
        self.temperature = temperature
        self.softmax_temperature = (nn.Parameter(torch.ones(1)) if learn_temperature else None)
        self.out_features = 2 * channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x (B, C, H, W)
        temp = self.temperature if self.softmax_temperature is None else self.softmax_temperature
        attn = torch.softmax(x.flatten(2) / temp, dim=-1)
        return torch.cat([(self.pos_x * attn).sum(-1), (self.pos_y * attn).sum(-1)], -1)


def add_spatial_coordinates(x: torch.Tensor) -> torch.Tensor:
    """flax's AddSpatialCoordinates on NCHW `x`: two more channels, the row's
    then the column's coordinate in [-1, 1]."""
    b, _, h, w = x.shape
    rows = torch.arange(h, dtype=torch.float64) / (h - 1) * 2 - 1  # in float64, as numpy
    cols = torch.arange(w, dtype=torch.float64) / (w - 1) * 2 - 1
    grid = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), 0).to(x.device, x.dtype)
    return torch.cat([x, grid.expand(b, 2, h, w)], 1)


POOLING_METHODS = ("spatial_learned_embeddings", "spatial_softmax", "avg", "max", "none")


class Pool(nn.Module):
    """serl_tpu's `_pool` over NCHW fp32 features (C, H, W): "avg", "max"
    (B, C); "spatial_learned_embeddings" (B, C * num_spatial_blocks), then
    dropout in train mode; "spatial_softmax" (B, 2C); "none" the NHWC map."""

    def __init__(self, method: str, feature_shape: Tuple[int, int, int],
                 num_spatial_blocks: int = 8, generator=None):
        super().__init__()
        if method not in POOLING_METHODS:
            raise ValueError(f"unknown pooling method {method}")
        c, h, w = feature_shape
        self.method = method
        self.embeddings = self.softmax = None
        if method == "spatial_learned_embeddings":
            self.embeddings = SpatialLearnedEmbeddings(h, w, c, num_spatial_blocks, generator)
        elif method == "spatial_softmax":
            self.softmax = SpatialSoftmax(h, w, c)
        self.out_features = {"spatial_learned_embeddings": c * num_spatial_blocks,
                             "spatial_softmax": 2 * c, "avg": c, "max": c,
                             "none": None}[method]
        # width of the dropout mask the head draws in train mode (0: none)
        self.dropout_features = c * num_spatial_blocks if self.embeddings is not None else 0

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.embeddings is not None:
            return dropout(self.embeddings(x), train, dropout_mask)
        if self.softmax is not None:
            return self.softmax(x)
        if self.method == "avg":
            return x.mean(dim=(-2, -1))
        if self.method == "max":
            return x.amax(dim=(-2, -1))
        return x.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """Dense -> LayerNorm -> tanh (serl_tpu's `_bottleneck`)."""

    def __init__(self, in_features: int, dim: int, generator=None):
        super().__init__()
        self.dense = lecun_dense(in_features, dim, generator)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_layer_norm_tanh(x, self.dense.weight, self.dense.bias, self.norm.weight,
                                     self.norm.bias)


# ---------------------------------------------------------------- ResNet-v1


class Norm(nn.Module):
    """GroupNorm(4 groups) or LayerNorm over the channels, eps 1e-5, in fp32
    (flax computes both in fp32 and returns fp32 for fp32 params). Both work
    on the NHWC memory of the channels_last activations, where a group's
    channels are contiguous: no layout copy (torch's group_norm takes NCHW
    and would copy the map both ways)."""

    def __init__(self, kind: str, channels: int, zero_scale: bool = False):
        super().__init__()
        if kind not in ("group", "layer"):
            raise ValueError(kind)
        self.groups = 4 if kind == "group" else 1
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x (B, C, H, W), channels_last
        b, c, h, w = x.shape
        nhwc = x.float().permute(0, 2, 3, 1)
        if self.groups == 1:  # LayerNorm over each pixel's channels
            y = F.layer_norm(nhwc, (c,), self.weight, self.bias, RESNET_NORM_EPS)
            return y.permute(0, 3, 1, 2)
        xg = nhwc.reshape(b, h * w, self.groups, c // self.groups)
        var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
        scale = torch.rsqrt(var + RESNET_NORM_EPS) * self.weight.view(self.groups, -1)
        shift = self.bias.view(self.groups, -1) - mean * scale
        y = torch.addcmul(shift, xg, scale)  # (x - mean) * rsqrt(var + eps) * w + b
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _conv(in_channels: int, out_channels: int, k: int, generator=None) -> nn.Conv2d:
    """A bias-free Conv2d with flax's kaiming_normal kernel, channels_last."""
    conv = nn.Conv2d(in_channels, out_channels, k, bias=False)
    variance_scaling_(conv.weight, 2.0, in_channels * k * k, generator)
    conv.weight.data = conv.weight.data.contiguous(memory_format=torch.channels_last)
    return conv


class ResNetBlock(nn.Module):
    """Basic block: conv 3x3 (stride) -> norm -> act -> conv 3x3 -> norm, plus
    the residual (projected by a strided 1x1 conv and a norm when its shape
    changes), then act; the convolutions in compute dtype. flax names:
    Conv_0, <Norm>_0, Conv_1, <Norm>_1, conv_proj, norm_proj."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, in_size: Tuple[int, int], stride: int = 1,
                 norm: str = "group", act: str = "relu",
                 compute_dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.filters, self.stride, self.compute_dtype = filters, stride, compute_dtype
        self.out_channels = filters * self.expansion
        self.act = _ACTIVATIONS[act]
        self.convs, self.norms, self.strides = self._layers(in_channels, norm, generator)
        self.out_size = tuple(-(-s // stride) for s in in_size)
        self.conv_proj = self.norm_proj = None
        if in_channels != self.out_channels or tuple(in_size) != self.out_size:
            self.conv_proj = _conv(in_channels, self.out_channels, 1, generator)
            self.norm_proj = Norm(norm, self.out_channels)

    def _layers(self, in_channels, norm, generator):
        f = self.filters
        return (nn.ModuleList([_conv(in_channels, f, 3, generator), _conv(f, f, 3, generator)]),
                nn.ModuleList([Norm(norm, f), Norm(norm, f)]), (self.stride, 1))

    def _apply_conv(self, conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        w = conv.weight.to(dtype=self.compute_dtype, memory_format=torch.channels_last)
        return conv2d_same(x.to(self.compute_dtype), w, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        last = len(self.convs) - 1
        for i, (conv, norm, stride) in enumerate(zip(self.convs, self.norms, self.strides)):
            y = norm(self._apply_conv(conv, y, stride))
            if i < last:
                y = self.act(y)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self._apply_conv(self.conv_proj, x, self.stride))
        return self.act(residual + y)


class BottleneckResNetBlock(ResNetBlock):
    """Bottleneck block: conv 1x1 -> norm -> act -> conv 3x3 (stride) -> norm
    -> act -> conv 1x1 to 4 x filters -> norm whose scale starts at zero,
    plus the residual (projected as the basic block's), then act. flax
    names: Conv_0..2, <Norm>_0..2, conv_proj, norm_proj."""

    expansion = 4

    def _layers(self, in_channels, norm, generator):
        f = self.filters
        return (nn.ModuleList([_conv(in_channels, f, 1, generator), _conv(f, f, 3, generator),
                               _conv(f, 4 * f, 1, generator)]),
                nn.ModuleList([Norm(norm, f), Norm(norm, f), Norm(norm, 4 * f, zero_scale=True)]),
                (1, self.stride, 1))


class FilmConditioning(nn.Module):
    """FiLM: x * (1 + mult(c)) + add(c) per channel of NCHW `x`, `add` and
    `mult` Dense layers of the conditioning vector c, zero-initialised
    (kernel and bias), so the identity at init. flax names: Dense_0 (add),
    Dense_1 (mult)."""

    def __init__(self, cond_dim: int, channels: int):
        super().__init__()
        self.add = nn.Linear(cond_dim, channels)
        self.mult = nn.Linear(cond_dim, channels)
        for layer in (self.add, self.mult):
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        add = self.add(cond)[:, :, None, None]
        mult = self.mult(cond)[:, :, None, None]
        return x * (1.0 + mult) + add


def _pair(size: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (int(size), int(size)) if isinstance(size, int) else (int(size[0]), int(size[1]))


class ResNetEncoder(nn.Module):
    """ResNet-v1 with GroupNorm (serl_tpu's ResNetEncoder) on (B, H, W,
    in_channels) uint8 images of `image_size`: ImageNet normalisation in
    fp32, optional coordinate channels, a 7x7 stride-2 stem padded (3, 3),
    norm, act, a 3x3 stride-2 "SAME" max-pool, then the stages of basic
    blocks (the first block of every stage after the first strides 2).
    Then fp32, and with `pre_pooling` the (B, h, w, c) map, computed under
    no_grad (JAX's stop_gradient: a frozen backbone); else the pooling head
    and an optional Dense -> LayerNorm -> tanh bottleneck."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type = ResNetBlock,
        num_filters: int = 64,
        act: str = "relu",
        norm: str = "group",
        add_spatial_coordinates: bool = False,
        pooling_method: str = "avg",
        num_spatial_blocks: int = 8,
        use_film: bool = False,
        use_multiplicative_cond: bool = False,
        cond_dim: Optional[int] = None,
        bottleneck_dim: Optional[int] = None,
        pre_pooling: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
        image_size: Union[int, Sequence[int]] = 128,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if (use_film or use_multiplicative_cond) and cond_dim is None:
            raise ValueError("a conditioned ResNet needs cond_dim, the conditioning's width")
        self.stage_sizes = tuple(stage_sizes)
        self.norm_kind = norm
        self.act = _ACTIVATIONS[act]
        self.add_coords = add_spatial_coordinates
        self.pre_pooling = pre_pooling
        self.compute_dtype = compute_dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        h, w = _pair(image_size)
        c = in_channels + (2 if add_spatial_coordinates else 0)
        self.conv_init = _conv(c, num_filters, 7, generator)
        self.norm_init = Norm(norm, num_filters)
        size = (-(-h // 2), -(-w // 2))  # the stem: 7x7, stride 2, padding (3, 3)
        size = tuple(-(-s // 2) for s in size)  # the max-pool: 3x3, stride 2, "SAME"
        c = num_filters
        self.blocks = nn.ModuleList()
        self.films = nn.ModuleList() if use_film else None
        self.cond_dense = nn.ModuleList() if use_multiplicative_cond else None
        for i, block_size in enumerate(self.stage_sizes):
            for j in range(block_size):
                block = block_cls(c, num_filters * 2 ** i, size, 2 if i > 0 and j == 0 else 1,
                                  norm, act, compute_dtype, generator)
                self.blocks.append(block)
                size, c = block.out_size, block.out_channels
                if use_film:
                    self.films.append(FilmConditioning(cond_dim, c))
                if use_multiplicative_cond:
                    layer = nn.Linear(cond_dim, c)
                    variance_scaling_(layer.weight, 1.0, (cond_dim + c) / 2, generator)  # xavier
                    nn.init.zeros_(layer.bias)
                    self.cond_dense.append(layer)
        self.feature_shape = (size[0], size[1], c)  # (h, w, c) of the map
        self.pool = self.bottleneck = None
        if pre_pooling:
            self.out_features = None
            self.dropout_features = 0
            return
        self.pool = Pool(pooling_method, (c, size[0], size[1]), num_spatial_blocks, generator)
        self.dropout_features = self.pool.dropout_features
        self.out_features = self.pool.out_features
        if bottleneck_dim is not None:
            self.bottleneck = Bottleneck(self.out_features, bottleneck_dim, generator)
            self.out_features = bottleneck_dim

    def _backbone(self, observations: torch.Tensor, cond_var=None) -> torch.Tensor:
        """(B, H, W, C) uint8 -> the (B, c, h, w) fp32 map (channels_last)."""
        if (self.films is not None or self.cond_dense is not None) and cond_var is None:
            raise ValueError("this ResNet is conditioned: pass cond_var")
        cd = self.compute_dtype
        x = (observations.to(torch.float32) / 255.0 - self.mean) / self.std
        x = x.permute(0, 3, 1, 2)  # an NCHW view of the NHWC images
        if self.add_coords:
            x = add_spatial_coordinates(x)
        with _tf32_convs(x.device, cd):
            w = self.conv_init.weight.to(dtype=cd, memory_format=torch.channels_last)
            x = F.conv2d(x.to(cd), w, stride=2, padding=3)
            x = max_pool_same(self.act(self.norm_init(x)))
            for i, block in enumerate(self.blocks):
                x = block(x)
                if self.films is not None:
                    x = self.films[i](x, cond_var)
                if self.cond_dense is not None:
                    x = x * self.cond_dense[i](cond_var)[:, :, None, None]
        return x.to(torch.float32)

    def forward(self, observations: torch.Tensor, train: bool = False,
                dropout: Optional[torch.Tensor] = None, cond_var=None) -> torch.Tensor:
        if self.pre_pooling:
            with torch.no_grad():  # frozen features: no gradient, no saved activations
                return self._backbone(observations, cond_var).permute(0, 2, 3, 1)
        x = self.pool(self._backbone(observations, cond_var), train, dropout)
        return x if self.bottleneck is None else self.bottleneck(x)


class PreTrainedResNetEncoder(nn.Module):
    """A trainable pooling head (and bottleneck) over a pre-pooling ResNet."""

    def __init__(self, pretrained_encoder: ResNetEncoder, pooling_method: str = "avg",
                 num_spatial_blocks: int = 8, bottleneck_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not pretrained_encoder.pre_pooling:
            raise ValueError("the pretrained encoder must return its pre-pooling map")
        self.pretrained_encoder = pretrained_encoder
        h, w, c = pretrained_encoder.feature_shape
        self.pool = Pool(pooling_method, (c, h, w), num_spatial_blocks, generator)
        self.dropout_features = self.pool.dropout_features
        self.out_features = self.pool.out_features
        self.bottleneck = None
        if bottleneck_dim is not None:
            self.bottleneck = Bottleneck(self.out_features, bottleneck_dim, generator)
            self.out_features = bottleneck_dim

    def forward(self, observations: torch.Tensor, train: bool = False,
                dropout: Optional[torch.Tensor] = None, encode: bool = True) -> torch.Tensor:
        """`encode=False`: `observations` are already the (B, h, w, c) map."""
        x = self.pretrained_encoder(observations) if encode else observations
        x = self.pool(x.permute(0, 3, 1, 2), train, dropout)
        return x if self.bottleneck is None else self.bottleneck(x)


def _resnet(stage_sizes, block_cls=ResNetBlock, **kw):
    return functools.partial(ResNetEncoder, stage_sizes=stage_sizes, block_cls=block_cls, **kw)


resnetv1_configs = {
    "resnetv1-10": _resnet((1, 1, 1, 1)),
    "resnetv1-10-frozen": _resnet((1, 1, 1, 1), pre_pooling=True),
    "resnetv1-18": _resnet((2, 2, 2, 2)),
    "resnetv1-34": _resnet((3, 4, 6, 3)),
    "resnetv1-50": _resnet((3, 4, 6, 3), BottleneckResNetBlock),
    "resnetv1-18-bridge": _resnet((2, 2, 2, 2), num_spatial_blocks=8),
    "resnetv1-34-bridge": _resnet((3, 4, 6, 3), num_spatial_blocks=8),
    "resnetv1-34-bridge-film": _resnet((3, 4, 6, 3), num_spatial_blocks=8, use_film=True),
    "resnetv1-50-bridge": _resnet((3, 4, 6, 3), BottleneckResNetBlock, num_spatial_blocks=8),
}


# ---------------------------------------------------------------- SmallEncoder


class SmallEncoder(nn.Module):
    """4-conv encoder: x / 255 in `compute_dtype`, Conv + relu per feature
    size (padding "VALID", "SAME" or an int per layer, as flax reads them),
    then fp32 pooling (any of POOLING_METHODS; the learned-embedding head
    has `spatial_block_size` features per channel and dropout in train mode)
    and an optional Dense -> LayerNorm -> tanh bottleneck. Input (B, H, W,
    in_channels) of `image_size`; `in_channels` is the image's channels times
    the frame stack. `image_size` sizes the learned-embedding and softmax
    heads; the others do not need it. `encode` is accepted and ignored, as
    the JAX module does.

    The stem switches: `pad_input_channels` zero-pads the input's channels
    to that many (the same function: the extra kernel taps see zeros);
    `space_to_depth_stem` (with a first stride of 2) makes the first conv a
    space-to-depth(2), each 2x2 block's pixels as 4C channels in (column,
    row, channel) order, then a 2x2 stride-1 "VALID" conv."""

    def __init__(
        self,
        in_channels: int = 3,
        features: Sequence[int] = (32, 64, 128, 256),
        kernel_sizes: Sequence[int] = (3, 3, 3, 3),
        strides: Sequence[int] = (2, 2, 2, 2),
        padding: Union[str, Sequence[Union[int, str]]] = "VALID",
        pool_method: str = "avg",
        bottleneck_dim: Optional[int] = 256,
        compute_dtype: torch.dtype = torch.float32,
        spatial_block_size: int = 8,
        image_size: Optional[Union[int, Sequence[int]]] = None,
        generator: Optional[torch.Generator] = None,
        pad_input_channels: Optional[int] = None,
        space_to_depth_stem: bool = False,
    ):
        super().__init__()
        spatial = pool_method in ("spatial_learned_embeddings", "spatial_softmax")
        self.pad_channels = max((pad_input_channels or 0) - in_channels, 0)
        self.space_to_depth = bool(space_to_depth_stem) and strides[0] == 2
        in_channels += self.pad_channels
        if spatial and image_size is None:
            raise ValueError(f"{pool_method} pooling needs image_size to size its head")
        self.compute_dtype = compute_dtype
        self.strides = tuple(strides)
        self.paddings = ((padding,) * len(features) if isinstance(padding, str)
                         else tuple(padding))
        h, w = _pair(image_size) if image_size is not None else (1, 1)
        sizes = [in_channels] + list(features)
        kernel_sizes, strides = list(kernel_sizes), list(strides)
        if self.space_to_depth:
            sizes[0] *= 4
            h, w = h // 2, w // 2
            kernel_sizes[0], strides[0], self.paddings = 2, 1, ("VALID",) + self.paddings[1:]
            self.strides = tuple(strides)
        self.convs = nn.ModuleList()
        for cin, cout, k, stride, pad in zip(sizes[:-1], sizes[1:], kernel_sizes, strides,
                                             self.paddings):
            conv = nn.Conv2d(cin, cout, k, bias=True)
            lecun_normal_(conv.weight, cin * k * k, generator)
            with torch.no_grad():
                conv.bias.zero_()
            self.convs.append(conv)
            h, w = conv_out_size(h, k, stride, pad), conv_out_size(w, k, stride, pad)
        self.pool = Pool(pool_method, (features[-1], h, w), spatial_block_size, generator)
        self.dropout_features = self.pool.dropout_features
        self.bottleneck = (None if bottleneck_dim is None
                           else Bottleneck(self.pool.out_features, bottleneck_dim, generator))
        self.out_features = self.pool.out_features if bottleneck_dim is None else bottleneck_dim

    def forward(self, observations: torch.Tensor, train: bool = False,
                dropout: Optional[torch.Tensor] = None, encode: bool = True) -> torch.Tensor:
        cd = self.compute_dtype
        x = observations.to(cd) / 255.0
        if self.pad_channels:
            x = F.pad(x, (0, self.pad_channels))
        if self.space_to_depth:
            b, h, w, c = x.shape
            # (b, h/2, dy, w/2, dx, c) -> (b, h/2, w/2, dx, dy, c), the JAX module's order
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(
                b, h // 2, w // 2, 4 * c)
        # NHWC -> an NCHW view with channels_last strides
        x = x.permute(0, 3, 1, 2)
        for conv, stride, pad in zip(self.convs, self.strides, self.paddings):
            w = conv.weight.to(dtype=cd, memory_format=torch.channels_last)
            b = conv.bias.to(cd)
            if pad == "SAME":
                x = conv2d_same(x, w, stride, bias=b)
            else:
                x = F.conv2d(x, w, b, stride=stride, padding=0 if pad == "VALID" else int(pad))
            x = F.relu(x)
        x = self.pool(x.to(torch.float32), train, dropout)
        if self.bottleneck is not None:
            x = self.bottleneck(x)
        return x


small_configs = {"small": SmallEncoder}
