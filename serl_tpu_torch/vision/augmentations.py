"""DrQ's random crop (K3).

Port of `batched_random_crop`, `_crop_indices` and
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

The photometric augmentations of the JAX module are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence

import torch


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
