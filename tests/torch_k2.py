"""Checks of K2, the render kernel, shared by the CPU tests and chip_smoke.py.

  * `pixel_rule(got, want)`: how two renders of the same states are held to
    each other (kernel against its plain version on the card, the port
    against the JAX package on the CPU).
  * `host_render(state, size)`: the kernel's own per-pixel code
    (serl_tpu_torch/csrc/render.cuh) built for the CPU with g++ from
    tests/k2_host.cpp, over CPU states.
  * `render_ops(state, size)`: the float32 operations that code executes
    for a render of `state`, for K2's bound.

The pixel rule. Two float32 renders of the same scene agree to within one
uint8 level wherever the ray hits the same surface: the shading is smooth and
the two may round differently only by a few ulp before the x255 truncation.
Where the ray grazes a silhouette, a checker line or the edge of a box face,
a difference of one ulp in a hit distance can flip which primitive (or which
face, or which checker square) the pixel takes, and the colours then differ
by anything. The expected number of such flips is the number of edge pixels
(a few thousand in a 128x128 frame) times the chance that a rounding-level
shift of the geometry (~1e-6 m, against a pixel footprint of ~7e-3 m at 1 m)
crosses the pixel's centre, ~1e-4: well under one pixel per frame. So:
  * at most FLIP_SHARE (0.5%) of all pixels may differ by more than 1 level
    in a channel, a bound some 50x above the expected count, so that only a
    real fault (a wrong primitive, a lost refinement, a wrong light) breaks
    it, since those move whole regions;
  * every such pixel must lie on an edge of the reference frame: its 3x3
    neighbourhood spans more than EDGE_LEVELS (8) levels in some channel.
    Smooth shading moves at most a few levels per pixel, and the smallest
    colour step between two surfaces, the floor's checker, is ~16 levels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Tuple

import torch

from serl_tpu_torch.envs import rendering

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "serl_tpu_torch", "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

FLIP_SHARE = 0.005
EDGE_LEVELS = 8


def edge_mask(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool: pixels whose 3x3 neighbourhood in `img` (..., H, W, 3)
    uint8 spans more than EDGE_LEVELS levels in some channel."""
    x = img.to(torch.float32).movedim(-1, -3)  # (..., 3, H, W)
    lead = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    hi = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    lo = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return ((hi - lo) > EDGE_LEVELS).any(1).reshape(lead + tuple(x.shape[-2:]))


def pixel_rule(got: torch.Tensor, want: torch.Tensor) -> Tuple[List[str], Dict]:
    """Hold `got` to `want` ((N, H, W, 3) uint8 each) by the rule above.
    Returns (failures, summary)."""
    if got.shape != want.shape or got.dtype != torch.uint8 or want.dtype != torch.uint8:
        return [f"shapes/dtypes {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                f"{want.dtype}"], {}
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)  # (N, H, W)
    beyond = diff > 1
    edges = edge_mask(want)
    n_beyond = int(beyond.sum())
    off_edge = int((beyond & ~edges).sum())
    share = n_beyond / diff.numel()
    summary = {"pixels": diff.numel(), "beyond_1": n_beyond, "share_beyond_1": share,
               "beyond_1_off_edge": off_edge, "max_level_diff": int(diff.max()),
               "edge_share": float(edges.float().mean())}
    failures = []
    if share > FLIP_SHARE:
        failures.append(f"{n_beyond} of {diff.numel()} pixels differ by more than 1 level "
                        f"(share {share:.4g} > {FLIP_SHARE})")
    if off_edge:
        failures.append(f"{off_edge} pixels differ by more than 1 level off any edge")
    return failures, summary


# ---------------------------------------------------------------- host builds


def _compiler() -> str:
    for name in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH)")


@functools.lru_cache(maxsize=None)
def _host_library(count_ops: bool, csrc: str) -> ctypes.CDLL:
    source = os.path.join(HERE, "k2_host.cpp")
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
    if count_ops:
        flags.append("-DSERL_COUNT_OPS")
    h = hashlib.sha256(" ".join(flags + [os.path.abspath(csrc)]).encode())
    for path in (source, os.path.join(csrc, "render.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    name = "count" if count_ops else "render"
    out = os.path.join(BUILD_DIR, f"libk2_{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_compiler(), *flags, "-I", csrc, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {source} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    ptr, n = ctypes.c_void_p, ctypes.c_int
    if count_ops:
        lib.k2_count_ops.argtypes = [ptr, ptr, ptr, n, n]
        lib.k2_count_ops.restype = ctypes.c_int64
    else:
        lib.k2_host_render.argtypes = [ptr] * 5 + [n, n]
        lib.k2_host_render.restype = None
    return lib


def host_render(state, size: int, csrc: str = CSRC):
    """(front, wrist) of CPU physics `state` by the kernel's per-pixel code
    built for the CPU (`csrc` names another copy of render.cuh, for a planted
    fault)."""
    if state.qpos.device.type != "cpu":
        raise ValueError(f"host_render needs CPU tensors, got {state.qpos.device}")
    lib = _host_library(False, csrc)
    scene = rendering.pack_scene(state)
    grid = rendering.pixel_grid(size, "cpu")
    consts = torch.as_tensor(rendering.RENDER_CONSTANTS)
    n = scene.shape[0]
    front = torch.empty((n, size, size, 3), dtype=torch.uint8)
    wrist = torch.empty_like(front)
    lib.k2_host_render(scene.data_ptr(), grid.data_ptr(), consts.data_ptr(), front.data_ptr(),
                       wrist.data_ptr(), n, size * size)
    return front, wrist


def render_ops(state, size: int) -> int:
    """float32 operations that rendering both cameras of every env of
    `state` at `size` executes in the kernel's code (counted as
    k2_host.cpp says); `state` may lie on any device."""
    lib = _host_library(True, CSRC)
    state = rendering.engine.PhysicsState(*(x.detach().to("cpu") for x in state))
    scene = rendering.pack_scene(state)
    grid = rendering.pixel_grid(size, "cpu")
    consts = torch.as_tensor(rendering.RENDER_CONSTANTS)
    return int(lib.k2_count_ops(scene.data_ptr(), grid.data_ptr(), consts.data_ptr(),
                                scene.shape[0], size * size))
