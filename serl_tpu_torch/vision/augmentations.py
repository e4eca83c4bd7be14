"""DrQ's random crop (K3).

Port of `random_crop`, `batched_random_crop`, `_crop_indices` and
`batched_random_crop_gather` from `serl_tpu/vision/augmentations.py`. The
crop pads each image by `padding` pixels of edge replication and cuts a
window of the original size at a random offset, independently for every
image: out[b, i, j] = img[b, clip(i + dy_b - pad, 0, H - 1),
clip(j + dx_b - pad, 0, W - 1)], with (dy_b, dx_b) in [0, 2 * pad].

The JAX package computes the uint8 crop as one-hot bf16 matmuls, only
because TPU gathers scalarise; the function is the gather, and both are
exact. Here the offsets are explicit (B, 2) integer tensors, (row, column)
per image as `_crop_indices` draws them, so the tests can feed JAX's draws;
`crop_offsets` draws them from a `torch.Generator`.

  * `batched_random_crop_gather`: the gather in plain PyTorch. CPU tensors
    take it; on the card only tests and chip_smoke.py call it.
  * the CUDA kernel in `serl_tpu_torch/csrc/random_crop.cu` (per-thread
    code in `csrc/random_crop.cuh`), which `crop_images` launches for CUDA
    tensors (one launch for a list of same-shaped images, so DrQ crops every
    image key of obs and next_obs at once), counting its launches in
    `crop_images.launches`. It shifts each row in 16-byte units where rows
    and bases allow, else in words or bytes, and copies bytes, so it serves
    float images exactly as well: where the JAX package sends float inputs
    to its gather form, here both dtypes take the same gather. A row of more
    than ~40 KB (a block's shared memory) is refused.

The photometric augmentations (`rgb_to_hsv`, `hsv_to_rgb`,
`to_grayscale`, `color_transform`, `gaussian_blur`, `random_flip`,
`solarize`) are plain torch on float images in [0, 1], as the JAX module
computes them; each random number is the caller's (`color_draws`,
`blur_draws` draw them from a generator), and no path launches them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


def crop_offsets(n: int, padding: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """(n, 2) int64 (row, column) window offsets, uniform in [0, 2 * padding]."""
    return torch.randint(0, 2 * padding + 1, (n, 2), generator=generator, device=device)


def crop_indices(offsets: torch.Tensor, h: int, w: int, padding: int):
    """Edge-clamped source rows (B, H) and columns (B, W) of each crop."""
    rows = torch.clamp(torch.arange(h, device=offsets.device)[None, :] + offsets[:, 0:1]
                       - padding, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=offsets.device)[None, :] + offsets[:, 1:2]
                       - padding, 0, w - 1)
    return rows, cols


def _flat(img: torch.Tensor, offsets: torch.Tensor, num_batch_dims: int) -> torch.Tensor:
    if img.dim() != num_batch_dims + 3:
        raise ValueError(f"image of shape {tuple(img.shape)}: want {num_batch_dims} batch dims "
                         "then (H, W, C)")
    b = math.prod(img.shape[:num_batch_dims])
    if tuple(offsets.shape) != (b, 2):
        raise ValueError(f"offsets of shape {tuple(offsets.shape)}: want ({b}, 2)")
    return img.reshape((b,) + tuple(img.shape[num_batch_dims:]))


def batched_random_crop_gather(img: torch.Tensor, offsets: torch.Tensor, *, padding: int,
                               num_batch_dims: int = 1) -> torch.Tensor:
    """The crop as a gather, in plain PyTorch: img (*batch, H, W, C),
    offsets (prod(batch), 2)."""
    flat = _flat(img, offsets, num_batch_dims)
    b, h, w = flat.shape[:3]
    rows, cols = crop_indices(offsets, h, w, padding)
    idx = torch.arange(b, device=img.device)[:, None, None]
    return flat[idx, rows[:, :, None], cols[:, None, :]].reshape(img.shape)


@functools.lru_cache(maxsize=None)
def _crop_library():
    """Build (once per source hash) and bind the random-crop kernel."""
    from serl_tpu_torch.native.build import load_library

    lib = load_library("random_crop")
    lib.serl_random_crop.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.serl_random_crop.restype = ctypes.c_int
    lib.serl_random_crop_max_jobs.argtypes = []
    lib.serl_random_crop_max_jobs.restype = ctypes.c_int
    lib.serl_random_crop_error_string.argtypes = [ctypes.c_int]
    lib.serl_random_crop_error_string.restype = ctypes.c_char_p
    lib.serl_random_crop_unit.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    lib.serl_random_crop_unit.restype = ctypes.c_int
    return lib


def _crop_cuda(images: Sequence[torch.Tensor], offsets: Sequence[torch.Tensor], padding: int,
               num_batch_dims: int) -> List[torch.Tensor]:
    first = images[0]
    device = first.device
    flats = []
    for img, off in zip(images, offsets):
        if (img.device != device or img.dtype != first.dtype or img.shape != first.shape
                or not img.is_contiguous()):
            raise ValueError(f"crop_images: every image must be contiguous {first.dtype} "
                             f"{tuple(first.shape)} on {device}, got {img.dtype} "
                             f"{tuple(img.shape)} on {img.device}")
        if off.dtype != torch.int64 or off.device != device or not off.is_contiguous():
            raise ValueError(f"crop_images: offsets must be contiguous int64 on {device}")
        flats.append(_flat(img, off, num_batch_dims))
    b, h, w, c = flats[0].shape
    lib = _crop_library()
    if len(flats) > lib.serl_random_crop_max_jobs():
        raise ValueError(f"{len(flats)} images, the kernel takes at most "
                         f"{lib.serl_random_crop_max_jobs()} per launch")
    outs = [torch.empty_like(img) for img in images]
    n = len(flats)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.serl_random_crop(ptrs(flats), ptrs(outs), ptrs(offsets), n, b, h, w,
                                  c * first.element_size(), int(padding), stream)
    if rc != 0:
        raise RuntimeError("random crop kernel launch failed: "
                           f"{lib.serl_random_crop_error_string(rc).decode()}")
    crop_images.launches += 1
    return outs


def crop_images(images: Sequence[torch.Tensor], offsets: Sequence[torch.Tensor], *,
                padding: int, num_batch_dims: int = 1) -> List[torch.Tensor]:
    """K3 over a list of same-shaped images (*batch, H, W, C), each with its
    (prod(batch), 2) offsets. CPU tensors take the plain gather; CUDA
    tensors launch the kernel once for the whole list, or raise."""
    if len(images) != len(offsets) or not images:
        raise ValueError("crop_images needs one offsets tensor per image, and an image")
    if images[0].device.type == "cpu":
        return [batched_random_crop_gather(img, off, padding=padding,
                                           num_batch_dims=num_batch_dims)
                for img, off in zip(images, offsets)]
    return _crop_cuda(images, offsets, padding, num_batch_dims)


crop_images.launches = 0


def batched_random_crop(img: torch.Tensor, offsets: torch.Tensor, *, padding: int,
                        num_batch_dims: int = 1) -> torch.Tensor:
    """Random crop with edge padding, one window per leading-batch element:
    img (*batch, H, W, C), offsets (prod(batch), 2) in [0, 2 * padding]."""
    return crop_images([img], [offsets], padding=padding, num_batch_dims=num_batch_dims)[0]


def random_crop(img: torch.Tensor, offsets: torch.Tensor, *, padding: int) -> torch.Tensor:
    """One image (H, W, C) through the batched crop: offsets (1, 2) or (2,),
    its (row, column) window offset in [0, 2 * padding]."""
    return batched_random_crop(img[None], offsets.reshape(1, 2), padding=padding)[0]


# ------------------------------------------------------------------ photometric


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> (..., 3) HSV, hue in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    rng = v - torch.minimum(torch.minimum(r, g), b)
    s = torch.where(v > 0, rng / v, 0.0)
    norm = torch.where(rng != 0, 1.0 / (6.0 * rng), 1e9)
    hr = norm * (g - b)
    hg = norm * (b - r) + 2.0 / 6.0
    hb = norm * (r - g) + 4.0 / 6.0
    h = torch.where(r == v, hr, torch.where(g == v, hg, hb))
    h = h * (rng > 0)
    h = h + (h < 0)
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV -> (..., 3) RGB."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = s * v
    m = v - c
    dh = (h % 1.0) * 6.0
    x = c * (1.0 - torch.abs(dh % 2.0 - 1.0))
    cat = torch.floor(dh).to(torch.int32)
    zero = torch.zeros_like(c)
    r = torch.where((cat == 0) | (cat == 5), c, torch.where((cat == 1) | (cat == 4), x, zero))
    g = torch.where((cat == 1) | (cat == 2), c, torch.where((cat == 0) | (cat == 3), x, zero))
    b = torch.where((cat == 3) | (cat == 4), c, torch.where((cat == 2) | (cat == 5), x, zero))
    return torch.stack([r + m, g + m, b + m], -1)


GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)


def to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """The luma of each pixel, repeated on the three channels."""
    gray = image @ torch.tensor(GRAY_WEIGHTS, dtype=image.dtype, device=image.device)
    return gray[..., None].repeat_interleave(3, -1)


def color_draws(generator: Optional[torch.Generator] = None, *, brightness: float = 0.2,
                contrast: float = 0.2, saturation: float = 0.2, hue: float = 0.05,
                device=None) -> Dict[str, torch.Tensor]:
    """One `color_transform`'s draws: the three uniforms of its apply,
    grayscale and jitter decisions, the brightness and hue offsets and
    the contrast and saturation factors (uniform in their ranges), and the
    jitter's order (a permutation of the four)."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((), generator=generator, device=device)
    return {"apply": u(0.0, 1.0), "gray": u(0.0, 1.0), "jitter": u(0.0, 1.0),
            "brightness": u(-brightness, brightness), "contrast": u(1 - contrast, 1 + contrast),
            "saturation": u(1 - saturation, 1 + saturation), "hue": u(-hue, hue),
            "order": torch.randperm(4, generator=generator, device=device)}


def color_transform(image: torch.Tensor, draws: Dict[str, torch.Tensor], *,
                    to_grayscale_prob: float = 0.0, color_jitter_prob: float = 1.0,
                    apply_prob: float = 1.0, shuffle: bool = False) -> torch.Tensor:
    """Color jitter of one float (H, W, C) image in [0, 1]: brightness,
    contrast, saturation and hue by `draws` (see `color_draws`), in that
    order or with `shuffle` in draws["order"], where draws["apply"] <=
    apply_prob and draws["jitter"] <= color_jitter_prob; then grayscale
    where draws["apply"] <= apply_prob and draws["gray"] <= to_grayscale_prob."""
    def bright(x):
        return torch.clamp(x + draws["brightness"], 0.0, 1.0)

    def contr(x):
        mean = x.mean(dim=(-3, -2), keepdim=True)
        return torch.clamp(draws["contrast"] * (x - mean) + mean, 0.0, 1.0)

    def satur(x):
        hsv = rgb_to_hsv(x)
        hsv = torch.stack([hsv[..., 0], torch.clamp(hsv[..., 1] * draws["saturation"], 0.0, 1.0),
                           hsv[..., 2]], -1)
        return torch.clamp(hsv_to_rgb(hsv), 0.0, 1.0)

    def huef(x):
        hsv = rgb_to_hsv(x)
        hsv = torch.stack([(hsv[..., 0] + draws["hue"]) % 1.0, hsv[..., 1], hsv[..., 2]], -1)
        return torch.clamp(hsv_to_rgb(hsv), 0.0, 1.0)

    fns = (bright, contr, satur, huef)
    x = image
    for i in (draws["order"].tolist() if shuffle else range(4)):
        x = fns[i](x)
    apply = draws["apply"] <= apply_prob
    out = torch.where(apply & (draws["jitter"] <= color_jitter_prob), x, image)
    out = torch.where(apply & (draws["gray"] <= to_grayscale_prob), to_grayscale(out), out)
    return torch.clamp(out, 0.0, 1.0)


def blur_draws(generator: Optional[torch.Generator] = None, *, sigma_min: float = 0.1,
               sigma_max: float = 2.0, device=None) -> Dict[str, torch.Tensor]:
    """One `gaussian_blur`'s draws: its apply uniform and its sigma."""
    u = torch.rand((2,), generator=generator, device=device)
    return {"apply": u[0], "sigma": sigma_min + (sigma_max - sigma_min) * u[1]}


def gaussian_blur(image: torch.Tensor, draws: Dict[str, torch.Tensor], *,
                  blur_divider: float = 10.0, apply_prob: float = 1.0) -> torch.Tensor:
    """Separable gaussian blur of one (H, W, C) image, kernel radius
    max(1, int(int(H / blur_divider) / 2)), sigma draws["sigma"], edges
    zero-padded ("SAME"), where draws["apply"] <= apply_prob."""
    radius = max(1, int(int(image.shape[0] / blur_divider) / 2))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=image.device)
    f = torch.exp(-(x ** 2) / (2.0 * draws["sigma"] ** 2))
    f = (f / f.sum()).to(image.dtype)
    c = image.shape[-1]
    img = image.permute(2, 0, 1)[None]  # (1, C, H, W)
    img = F.conv2d(img, f.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), padding=(0, radius),
                   groups=c)
    img = F.conv2d(img, f.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), padding=(radius, 0),
                   groups=c)
    blurred = img[0].permute(1, 2, 0)
    return torch.where(draws["apply"] <= apply_prob, blurred, image)


def random_flip(image: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The image mirrored left-right (its second-to-last axis) where the
    uniform `u` <= 0.5."""
    return torch.where(u <= 0.5, torch.flip(image, (-2,)), image)


def solarize(image: torch.Tensor, u: torch.Tensor, *, threshold: float = 0.5,
             apply_prob: float = 1.0) -> torch.Tensor:
    """Pixels at or above `threshold` inverted (1 - x), where the uniform
    `u` <= apply_prob."""
    sol = torch.where(image < threshold, image, 1.0 - image)
    return torch.where(u <= apply_prob, sol, image)
