"""Checks of K2, the render kernel, shared by the CPU tests and chip_smoke.py.

  * `pixel_rule(got, want, ids=None)`: how two renders of the same states
    are held to each other (kernel against its plain version on the card,
    the port against the JAX package on the CPU).
  * `surface_ids(state, size)`: the primitive each pixel of the plain
    render shows, for the rule's surface clause; `ray_hits(...)`: one
    pixel's ray against every primitive, in float32 or float64.
  * `host_scene(state)`: the kernel's scene rows (serl_tpu_torch/csrc/
    render.cuh's first stage) built for the CPU with g++ from
    tests/k2_host.cpp, over CPU states; `SCENE_ATOL` is how far they may be
    from `pack_scene`'s.
  * `host_render(state, size)`: the kernel's per-camera and per-pixel code,
    the same way, from `pack_scene`'s rows.
  * `render_ops(state, size)`: the float32 operations that code executes
    for a render of `state`, for K2's bound.
  * `host_library(source, header, csrc)`: a g++ build of a csrc header's
    host wrapper (K3's `tests/k3_host.cpp` too).

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
    neighbourhood spans more than EDGE_LEVELS (8) levels in some channel,
    or, where the caller gives the reference's surface ids (`surface_ids`),
    holds more than one surface. Smooth shading moves at most a few levels
    per pixel. Most surfaces meet with a step of 16 levels or more (the
    floor's checker), but two of one colour may not: the last arm capsule
    and the hand box are both dark grey (0.25), and where one occludes the
    other only their shading differs. chip_smoke.py's K2_GRAZE_STATE holds
    such a pixel: its ray grazes the capsule's end sphere at the capsule
    test's first sphere hit (`ray_hits`: in float64 the capsule at 1.0221
    m, the hand box behind at 1.0380; in the plain float32 arithmetic only
    the box), the kernel hits the capsule as float64 does (51 levels), the
    plain version shows the box (48 levels): 3 levels apart, an edge that
    the contrast alone does not mark. The surface clause marks it from the
    geometry.
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
# The kernel's scene rows against the plain version's: positions (m) and
# rotation entries. Both are float32 FK chains of 7 links from the same
# angles, whose sines and cosines and product orders round differently: a
# few float32 ulps of the ~1 m lever arms (6e-8 each), well under this.
SCENE_ATOL = 2e-6


def edge_mask(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool: pixels whose 3x3 neighbourhood in `img` (..., H, W, 3)
    uint8 spans more than EDGE_LEVELS levels in some channel."""
    x = img.to(torch.float32).movedim(-1, -3)  # (..., 3, H, W)
    lead = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    hi = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    lo = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return ((hi - lo) > EDGE_LEVELS).any(1).reshape(lead + tuple(x.shape[-2:]))


def surface_edge_mask(ids: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool: pixels whose 3x3 neighbourhood in `ids` (..., H, W)
    holds more than one surface."""
    x = ids.to(torch.float32).reshape((-1, 1) + tuple(ids.shape[-2:]))
    hi = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    lo = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return (hi != lo).reshape(ids.shape)


# the primitives in the plain version's render order (surface ids 0..12)
PRIMITIVES = (("floor",) + tuple(f"sphere {i}" for i in range(rendering.N_SPH))
              + tuple(f"capsule {i}" for i in range(rendering.N_CAP))
              + tuple(f"box {i}" for i in range(rendering.N_BOX)))


def _hit_distances(scene, rays) -> torch.Tensor:
    """(primitives, N, P) distance to each primitive along each ray (BIG
    where it misses), by the plain version's per-primitive code."""
    big = torch.full_like(rays[3], rendering.BIG)
    zero = torch.zeros_like(rays[3])
    fresh = (big, zero, zero, zero)
    ts = [rendering._render_plane(fresh, rays)[0]]
    ts += [rendering._render_sphere(fresh, rays, scene.sph_c[:, i], scene.sph_r[i],
                                    scene.sph_col[i])[0] for i in range(rendering.N_SPH)]
    ts += [rendering._render_capsule(fresh, rays, scene.cap_a[:, i], scene.cap_b[:, i],
                                     scene.cap_r[i], scene.cap_col[i])[0]
           for i in range(rendering.N_CAP)]
    ts += [rendering._render_box(fresh, rays, scene.box_c[:, i], scene.box_R[:, i],
                                 scene.box_h[i], scene.box_col[i])[0]
           for i in range(rendering.N_BOX)]
    return torch.stack(ts)


def surface_ids(state, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(front, wrist) (N, size, size) int64: the primitive (an index of
    PRIMITIVES) each pixel's ray meets first in the plain version's float32
    arithmetic, -1 for the sky. Ties go to the first in render order, as the
    render's strict running minimum keeps the first."""
    scene = rendering.build_scene(state)
    pos, rot = rendering.camera_poses(state)
    grid = rendering.pixel_grid(size, state.qpos.device)
    out = []
    for c in (0, 1):
        t = _hit_distances(scene, rendering.camera_rays(pos[:, c], rot[:, c], grid[c]))
        ids = torch.where(t.amin(0) < rendering.BIG, t.argmin(0), -1)
        out.append(ids.reshape(-1, size, size))
    return tuple(out)


def ray_hits(state, cam: int, row: int, col: int, size: int, dtype) -> Dict[str, float]:
    """Distance along one pixel's ray to every primitive it meets (misses
    left out), env 0 of `state`, the intersections computed in `dtype`
    from the float32 scene: float64 shows what the float32 versions round."""
    scene = rendering.Scene(*(x.to(dtype) for x in rendering.build_scene(state)))
    pos, rot = rendering.camera_poses(state)
    p = row * size + col
    grid = rendering.pixel_grid(size, state.qpos.device)[cam][:, p:p + 1].to(dtype)
    rays = rendering.camera_rays(pos[:1, cam].to(dtype), rot[:1, cam].to(dtype), grid)
    t = _hit_distances(scene, rays)[:, 0, 0].tolist()
    return {name: v for name, v in zip(PRIMITIVES, t) if v < rendering.BIG}


def pixel_rule(got: torch.Tensor, want: torch.Tensor,
               ids: torch.Tensor = None) -> Tuple[List[str], Dict]:
    """Hold `got` to `want` ((N, H, W, 3) uint8 each) by the rule above;
    `ids` ((N, H, W), `surface_ids` of the states `want` shows) adds the
    surface clause. Returns (failures, summary)."""
    if got.shape != want.shape or got.dtype != torch.uint8 or want.dtype != torch.uint8:
        return [f"shapes/dtypes {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                f"{want.dtype}"], {}
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)  # (N, H, W)
    beyond = diff > 1
    edges = edge_mask(want)
    surface_only = torch.zeros_like(beyond)
    if ids is not None:
        surface = surface_edge_mask(ids)
        surface_only = beyond & surface & ~edges
        edges = edges | surface
    n_beyond = int(beyond.sum())
    off_edge = int((beyond & ~edges).sum())
    share = n_beyond / diff.numel()
    summary = {"pixels": diff.numel(), "beyond_1": n_beyond, "share_beyond_1": share,
               "beyond_1_off_edge": off_edge, "max_level_diff": int(diff.max()),
               "edge_share": float(edges.float().mean())}
    if ids is not None:
        summary["beyond_1_on_surface_edge_only"] = [
            {"env": e, "row": r, "col": c, "got": got[e, r, c].tolist(),
             "want": want[e, r, c].tolist(),
             "surfaces": sorted(PRIMITIVES[i] if i >= 0 else "sky" for i in
                                ids[e, max(r - 1, 0):r + 2, max(c - 1, 0):c + 2].unique().tolist())}
            for e, r, c in surface_only.nonzero().tolist()]
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
def host_library(source: str, header: str, csrc: str = CSRC, flags: tuple = ()) -> ctypes.CDLL:
    """tests/<source> built with g++ (-ffp-contract=off, no contracted
    multiply-adds) against the `header` of `csrc` (another copy of the
    headers, for a planted fault), cached in tests/_build by a hash of both."""
    path = os.path.join(HERE, source)
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", *flags]
    h = hashlib.sha256(" ".join(flags + [os.path.abspath(csrc)]).encode())
    for f in (path, os.path.join(csrc, header)):
        with open(f, "rb") as fh:
            h.update(fh.read())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_compiler(), *flags, "-I", csrc, "-o", tmp, path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {path} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(out)


def _k2_library(count_ops: bool, csrc: str) -> ctypes.CDLL:
    lib = host_library("k2_host.cpp", "render.cuh", csrc,
                       ("-DSERL_COUNT_OPS",) if count_ops else ())
    ptr, n = ctypes.c_void_p, ctypes.c_int
    if count_ops:
        lib.k2_count_ops.argtypes = [ptr] * 6 + [n, n, ptr]
        lib.k2_count_ops.restype = None
    else:
        lib.k2_host_scene.argtypes = [ptr] * 5 + [n, ptr]
        lib.k2_host_scene.restype = None
        lib.k2_host_render.argtypes = [ptr] * 5 + [n, n]
        lib.k2_host_render.restype = None
        lib.k2_parity_mismatches.argtypes = []
        lib.k2_parity_mismatches.restype = ctypes.c_int64
    return lib


def _state_ptrs(state):
    fields = [getattr(state, k).contiguous() for k in ("qpos", "theta", "cube_pos", "cube_quat")]
    return fields, [x.data_ptr() for x in fields]


def _cpu(state):
    return rendering.engine.PhysicsState(*(x.detach().to("cpu") for x in state))


def host_scene(state, csrc: str = CSRC) -> torch.Tensor:
    """(N, SCENE_FLOATS) scene rows of CPU physics `state` by the kernel's
    first stage built for the CPU (`csrc` names another copy of render.cuh)."""
    if state.qpos.device.type != "cpu":
        raise ValueError(f"host_scene needs CPU tensors, got {state.qpos.device}")
    keep, ptrs = _state_ptrs(state)
    consts = torch.as_tensor(rendering.kernel_constants())
    out = torch.empty((state.qpos.shape[0], rendering.SCENE_FLOATS), dtype=torch.float32)
    _k2_library(False, csrc).k2_host_scene(*ptrs, consts.data_ptr(), out.shape[0], out.data_ptr())
    return out


def host_render(state, size: int, csrc: str = CSRC):
    """(front, wrist) of CPU physics `state` by the kernel's per-camera and
    per-pixel code built for the CPU, from `pack_scene`'s rows (`csrc` names
    another copy of render.cuh, for a planted fault)."""
    if state.qpos.device.type != "cpu":
        raise ValueError(f"host_render needs CPU tensors, got {state.qpos.device}")
    scene = rendering.pack_scene(state)
    grid = rendering.pixel_grid(size, "cpu")
    consts = torch.as_tensor(rendering.kernel_constants())
    n = scene.shape[0]
    front = torch.empty((n, size, size, 3), dtype=torch.uint8)
    wrist = torch.empty_like(front)
    _k2_library(False, csrc).k2_host_render(scene.data_ptr(), grid.data_ptr(), consts.data_ptr(),
                                            front.data_ptr(), wrist.data_ptr(), n, size * size)
    return front, wrist


def parity_mismatches() -> int:
    """Integer-valued floats where the pixel code's checker parity differs
    from fmodf(k, 2) == 0 (k2_host.cpp says which)."""
    return int(_k2_library(False, CSRC).k2_parity_mismatches())


# the per-pixel operations that the parity test `even` adds to fmodf's one
PARITY_EXTRA_OPS = 3


def render_ops(state, size: int) -> Dict[str, int]:
    """float32 operations that rendering both cameras of every env of
    `state` at `size` executes in the kernel's code (counted as k2_host.cpp
    says; `state` may lie on any device): `scene` (every env's row),
    `camera` (every (env, camera)'s invariants), `pixel` (every pixel), and
    `unhoisted`, the count of the same render with every camera invariant
    done once per pixel and fmodf for the parity."""
    state = _cpu(state)
    keep, ptrs = _state_ptrs(state)
    consts = torch.as_tensor(rendering.kernel_constants())
    grid = rendering.pixel_grid(size, "cpu")
    n, pixels = state.qpos.shape[0], size * size
    out = (ctypes.c_int64 * 3)()
    _k2_library(True, CSRC).k2_count_ops(*ptrs, consts.data_ptr(), grid.data_ptr(), n, pixels, out)
    scene, camera, pixel = (int(x) for x in out)
    return {"scene": scene, "camera": camera, "pixel": pixel,
            "unhoisted": pixel + camera * pixels - PARITY_EXTRA_OPS * 2 * n * pixels}
