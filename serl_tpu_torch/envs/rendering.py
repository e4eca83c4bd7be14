"""Batched camera rendering for image observations (K2).

Port of `serl_tpu/envs/rendering.py`: an analytic raycaster over a checker
floor, 2 spheres and 6 capsules (the arm) and 4 oriented boxes (cube, hand,
finger pads), built from the same FK the physics uses, with Lambert shading
under the MJCF light and a sky gradient; uint8 RGB for the `front` and
`wrist` cameras.

Where the JAX package renders one env per `vmap` lane, everything here is
batched over envs: `build_scene` runs the port's FK and pad kinematics for all
N envs at once, and `camera_poses` gives both cameras' poses (the front
camera is fixed; the wrist camera rides link 7 through the attachment body).

Two implementations of the render sit side by side:
  * `render_scene_plain` / `render_cameras_plain`: structure-of-arrays over
    (env, pixel) in plain PyTorch, following the JAX arithmetic op by op.
    CPU tensors take them; on the card only tests and chip_smoke.py call them.
  * the CUDA kernels in `serl_tpu_torch/csrc/render.cu` (per-thread code in
    `csrc/render.cuh`), which `render_cameras` launches for CUDA tensors,
    counting its launches in `render_cameras.launches`: a scene kernel
    computes each env's scene row (the row `pack_scene` packs, (N,
    SCENE_FLOATS) fp32) and its cameras' invariants from the physics state
    itself and one constant row (`kernel_constants`), then a pixel kernel
    renders both cameras; a render is two launches and no host work.
Both take the per-pixel (gx, gy) grid that `pixel_grid` builds with
`np.linspace` in float32 exactly as the JAX package does, so every ray is
the same ray.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from serl_tpu_torch.envs.physics import engine, gripper
from serl_tpu_torch.envs.physics import panda_model as pm
from serl_tpu_torch.envs.physics.arm import BODY_POS, BODY_RMAT, PINCH_POS_L7, PINCH_RMAT_L7, fk
from serl_tpu_torch.envs.physics.math3d import quat_to_mat, quat_to_mat_np

BIG = 1e9

_LINK_COL = np.asarray([0.85, 0.85, 0.87], np.float32)
_DARK_COL = np.asarray([0.25, 0.25, 0.25], np.float32)
_CUBE_COL = np.asarray([0.6, 0.3, 0.6], np.float32)
_PAD_COL = np.asarray([0.2, 0.2, 0.2], np.float32)

_LIGHT_DIR = np.asarray([0.3, 0.2, 1.0], np.float32) / np.linalg.norm(
    np.asarray([0.3, 0.2, 1.0], np.float32)
)
# the floor's normal is +z, so its Lambert factor is a constant
_PLANE_LIT = np.float32(0.55) + np.float32(0.55) * np.clip(_LIGHT_DIR[2], 0.0, 1.0)
_SKY_TOP = (0.3, 0.5, 0.7)
_SKY_BOT = (0.05, 0.05, 0.08)
_FLOOR_DARK = (0.1, 0.2, 0.3)
_FLOOR_LIGHT = (0.2, 0.3, 0.4)

_FRONT_R = quat_to_mat_np(pm.FRONT_CAM_QUAT)
_FRONT_POS = np.asarray(pm.FRONT_CAM_POS, np.float32)
_WRIST_R_ATT = quat_to_mat_np(pm.WRIST_CAM_QUAT_ATT)
_WRIST_POS_ATT = np.asarray(pm.WRIST_CAM_POS_ATT, np.float32)
_ATT_POS_L7 = np.asarray(pm.ATTACH_BODY_POS_L7, np.float32)
_ATT_R_L7 = quat_to_mat_np(pm.ATTACH_BODY_QUAT_L7)
FOVY = (float(pm.FRONT_CAM_FOVY), float(pm.WRIST_CAM_FOVY))  # front, wrist

# Packed scene row of one env (render.cuh reads the same offsets): two
# cameras (position 3, world<-camera rotation 9, row-major), then spheres
# (centre 3, radius, colour 3), capsules (a 3, b 3, radius, colour 3) and
# boxes (centre 3, world<-box rotation 9, half extents 3, colour 3).
N_SPH, N_CAP, N_BOX = 2, 6, 4
CAM_FLOATS, SPH_FLOATS, CAP_FLOATS, BOX_FLOATS = 12, 7, 10, 18
SCENE_FLOATS = 2 * CAM_FLOATS + N_SPH * SPH_FLOATS + N_CAP * CAP_FLOATS + N_BOX * BOX_FLOATS

# Render constants (render.cuh's K_* offsets): light direction, the floor's
# Lambert factor, sky bottom colour and top-minus-bottom span, the floor's
# dark and light checker colours. Each is the float32 value the JAX package
# computes (its Python-float differences round to float32 as weak types).
RENDER_CONSTANTS = np.asarray(
    list(_LIGHT_DIR) + [_PLANE_LIT] + list(_SKY_BOT)
    + [t - b for t, b in zip(_SKY_TOP, _SKY_BOT)] + list(_FLOOR_DARK) + list(_FLOOR_LIGHT),
    np.float32,
)


class Scene(NamedTuple):
    """Primitives of N envs (leading axis N on the per-env fields)."""

    sph_c: torch.Tensor  # (N, 2, 3) sphere centres
    sph_r: torch.Tensor  # (2,)
    sph_col: torch.Tensor  # (2, 3)
    cap_a: torch.Tensor  # (N, 6, 3) capsule endpoints
    cap_b: torch.Tensor  # (N, 6, 3)
    cap_r: torch.Tensor  # (6,)
    cap_col: torch.Tensor  # (6, 3)
    box_c: torch.Tensor  # (N, 4, 3) box centres
    box_R: torch.Tensor  # (N, 4, 3, 3) box orientation (world <- box)
    box_h: torch.Tensor  # (4, 3) half extents
    box_col: torch.Tensor  # (4, 3)


_FINGER_H = [0.012, 0.008, 0.030]
_WRIST_END = np.asarray([0.0, 0.0, 0.11], np.float32)  # the last capsule's end, pinch frame
_HAND = np.asarray([0.01, 0.0, 0.11], np.float32)  # the hand box's centre, pinch frame
_SPH_R = np.asarray([0.08, 0.07], np.float32)
_SPH_COL = np.stack([_LINK_COL, _LINK_COL])
_CAP_R = np.asarray([0.07, 0.07, 0.06, 0.06, 0.055, 0.05], np.float32)
_CAP_COL = np.stack([_LINK_COL] * 5 + [_DARK_COL])
_BOX_H = np.stack([np.asarray(pm.BLOCK_HALF, np.float32), np.asarray([0.03, 0.045, 0.035], np.float32),
                   np.asarray(_FINGER_H, np.float32), np.asarray(_FINGER_H, np.float32)])
_BOX_COL = np.stack([_CUBE_COL, _DARK_COL, _PAD_COL, _PAD_COL])


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """The scene's and cameras' constants as fp32 tensors on `device`, made
    once per device, so that a render copies nothing from the host."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {
        "wrist_end": t(_WRIST_END),
        "hand": t(_HAND),
        "cap_r": t(_CAP_R),
        "cap_col": t(_CAP_COL),
        "sph_r": t(_SPH_R),
        "sph_col": t(_SPH_COL),
        "box_h": t(_BOX_H),
        "box_col": t(_BOX_COL),
        "att_R": t(_ATT_R_L7),
        "att_pos": t(_ATT_POS_L7),
        "wrist_R": t(_WRIST_R_ATT),
        "wrist_pos": t(_WRIST_POS_ATT),
        "front_pos": t(_FRONT_POS),
        "front_R": t(_FRONT_R),
    }


def build_scene(state: engine.PhysicsState) -> Scene:
    """The render primitives of every env of `state` (serl_tpu's build_scene
    with the env axis written out)."""
    c = _consts(state.qpos.device)
    kin = fk(state.qpos)
    p = kin.p  # (N, 8, 3)
    pinch = kin.pinch_pos
    Rp = kin.pinch_rmat

    # arm as capsules between joint origins
    wrist_end = pinch - Rp @ c["wrist_end"]
    cap_a = torch.stack([torch.zeros_like(pinch), p[:, 1], p[:, 3], p[:, 4], p[:, 5], p[:, 7]], 1)
    cap_b = torch.stack([p[:, 1], p[:, 3], p[:, 4], p[:, 5], p[:, 7], wrist_end], 1)

    # joints as spheres for silhouette
    sph_c = torch.stack([p[:, 3], p[:, 5]], 1)

    # gripper: hand box and two finger boxes from the pad kinematics
    pk = gripper.pad_kinematics(state.theta)
    pad_pts = pinch[:, None] + pk.points @ Rp.transpose(-1, -2)  # (N, 4, 3)
    right_c = 0.5 * (pad_pts[:, 0] + pad_pts[:, 1])
    left_c = 0.5 * (pad_pts[:, 2] + pad_pts[:, 3])
    # keep the hand box clear of the wrist camera (at x=-0.05 on attachment)
    hand_c = pinch - Rp @ c["hand"]
    return Scene(
        sph_c=sph_c, sph_r=c["sph_r"], sph_col=c["sph_col"],
        cap_a=cap_a, cap_b=cap_b, cap_r=c["cap_r"], cap_col=c["cap_col"],
        box_c=torch.stack([state.cube_pos, hand_c, right_c, left_c], 1),
        box_R=torch.stack([quat_to_mat(state.cube_quat), Rp, Rp, Rp], 1),
        box_h=c["box_h"], box_col=c["box_col"],
    )


def camera_poses(state: engine.PhysicsState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions (N, 2, 3), rotations (N, 2, 3, 3)) of the front and wrist
    cameras; rotation columns are x = right, y = up, -z = view (MuJoCo)."""
    c = _consts(state.qpos.device)
    kin = fk(state.qpos)
    R7 = kin.R[:, 7]
    p7 = kin.p[:, 7]
    att_R = R7 @ c["att_R"]
    att_p = p7 + R7 @ c["att_pos"]
    wrist_R = att_R @ c["wrist_R"]
    wrist_p = att_p + att_R @ c["wrist_pos"]
    n = p7.shape[0]
    pos = torch.stack([c["front_pos"].expand(n, 3), wrist_p], 1)
    rot = torch.stack([c["front_R"].expand(n, 3, 3), wrist_R], 1)
    return pos, rot


@functools.lru_cache(maxsize=None)
def _pixel_grid_np(size: int) -> np.ndarray:
    """(2 cameras, 2 = gx/gy, size * size) float32, built as render_scene's
    np.linspace / meshgrid in float32."""
    out = np.empty((2, 2, size * size), np.float32)
    for cam, fovy in enumerate(FOVY):
        half = float(np.tan(np.deg2rad(fovy) / 2.0))
        ys = np.linspace(half, -half, size, dtype=np.float32)
        xs = np.linspace(-half, half, size, dtype=np.float32)
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        out[cam, 0] = gx.reshape(-1)
        out[cam, 1] = gy.reshape(-1)
    return out


@functools.lru_cache(maxsize=None)
def _pixel_grid_on(size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_pixel_grid_np(size), device=device)


def pixel_grid(size: int, device) -> torch.Tensor:
    """(2 cameras, 2, size * size) per-pixel (gx, gy) image-plane coordinates
    (made once per size and device)."""
    return _pixel_grid_on(int(size), torch.device(device))


# ---------------------------------------------------------------- plain


def _shade(cr, cg, cb, nx, ny, nz):
    """Lambert with headlight ambient (MJCF: ambient .5, diffuse .4)."""
    L = _LIGHT_DIR
    diff = torch.clamp(nx * float(L[0]) + ny * float(L[1]) + nz * float(L[2]), 0.0, 1.0)
    lit = 0.55 + 0.55 * diff
    return cr * lit, cg * lit, cb * lit


def _merge(best, t, shaded):
    """Running closest hit: strict < keeps the first of equal hits."""
    t_best, r, g, b = best
    sr, sg, sb = shaded
    m = t < t_best
    return torch.where(m, t, t_best), torch.where(m, sr, r), torch.where(m, sg, g), \
        torch.where(m, sb, b)


def _sphere_t_n(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    bx, by, bz = ox - cx, oy - cy, oz - cz
    b = bx * dx + by * dy + bz * dz
    cc = bx * bx + by * by + bz * bz - r * r
    disc = b * b - cc
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc > 0) & (t > 1e-4), t, BIG)
    rinv = 1.0 / torch.clamp(r, min=1e-9)
    return t, (bx + t * dx) * rinv, (by + t * dy) * rinv, (bz + t * dz) * rinv


def _col(col):
    return col[..., 0], col[..., 1], col[..., 2]


def _render_sphere(best, rays, c, r, col):
    ox, oy, oz, dx, dy, dz = rays
    t, nx, ny, nz = _sphere_t_n(ox, oy, oz, dx, dy, dz, c[:, 0:1], c[:, 1:2], c[:, 2:3], r)
    return _merge(best, t, _shade(*_col(col), nx, ny, nz))


def _render_capsule(best, rays, a, b, r, col):
    """Swept sphere: project the hit estimate onto the segment and
    sphere-test there, with two fixed-point refinements."""
    ox, oy, oz, dx, dy, dz = rays
    a0, a1, a2 = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    abx, aby, abz = b[:, 0:1] - a0, b[:, 1:2] - a1, b[:, 2:3] - a2
    ab2 = torch.clamp(abx * abx + aby * aby + abz * abz, min=1e-9)

    def sphere_at(s):
        cx, cy, cz = a0 + s * abx, a1 + s * aby, a2 + s * abz
        t = _sphere_t_n(ox, oy, oz, dx, dy, dz, cx, cy, cz, r)[0]
        return t, cx, cy, cz

    s = torch.clamp(((ox - a0) * abx + (oy - a1) * aby + (oz - a2) * abz) / ab2, 0.0, 1.0)
    for _ in range(2):
        t, _, _, _ = sphere_at(s)
        ts = torch.where(t >= BIG, 0.0, t)
        s = torch.clamp(((ox + ts * dx - a0) * abx + (oy + ts * dy - a1) * aby
                         + (oz + ts * dz - a2) * abz) / ab2, 0.0, 1.0)
    t, cx, cy, cz = sphere_at(s)
    ts = torch.where(t >= BIG, 0.0, t)
    nx, ny, nz = ox + ts * dx - cx, oy + ts * dy - cy, oz + ts * dz - cz
    inv = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-9)
    return _merge(best, t, _shade(*_col(col), nx * inv, ny * inv, nz * inv))


def _render_box(best, rays, c, R, h, col):
    """Oriented-box slab test. R: (N, 3, 3) world <- box."""
    ox, oy, oz, dx, dy, dz = rays
    wx, wy, wz = ox - c[:, 0:1], oy - c[:, 1:2], oz - c[:, 2:3]
    tmin = torch.full_like(dx, -BIG)
    tmax = torch.full_like(dx, BIG)
    entries, dls = [], []
    for k in range(3):
        r0, r1, r2 = R[:, 0, k:k + 1], R[:, 1, k:k + 1], R[:, 2, k:k + 1]
        ol = r0 * wx + r1 * wy + r2 * wz
        dl = r0 * dx + r1 * dy + r2 * dz
        guard = torch.where(dl >= 0, 1e-9, -1e-9)
        inv = 1.0 / torch.where(dl.abs() < 1e-9, guard, dl)
        t1 = (-h[k] - ol) * inv
        t2 = (h[k] - ol) * inv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin, tmax = torch.maximum(tmin, lo), torch.minimum(tmax, hi)
        entries.append(lo)
        dls.append(dl)
    hit_ok = tmax > torch.clamp(tmin, min=1e-4)
    t = torch.where(hit_ok & (tmin > 1e-4), tmin, BIG)
    # entry face: the axis with the largest slab entry (ties -> first);
    # world normal = -sign(dl) * R[:, axis]
    e0, e1, e2 = entries
    ax0 = (e0 >= e1) & (e0 >= e2)
    ax1 = ~ax0 & (e1 >= e2)
    ax2 = ~(ax0 | ax1)
    n = []
    for i in range(3):
        v = torch.zeros_like(dx)
        for axm, k in ((ax0, 0), (ax1, 1), (ax2, 2)):
            v = v + torch.where(axm, R[:, i, k:k + 1] * -torch.sign(dls[k]), 0.0)
        n.append(v)
    return _merge(best, t, _shade(*_col(col), *n))


def _render_plane(best, rays):
    """Checker floor at z = 0 (~0.75 m squares)."""
    ox, oy, oz, dx, dy, dz = rays
    t = torch.where(dz < -1e-6, -oz / dz, BIG)
    px, py = ox + t * dx, oy + t * dy
    k = torch.floor(px / 0.75) + torch.floor(py / 0.75)
    sel = torch.fmod(k, 2.0) == 0
    lit = float(_PLANE_LIT)
    shaded = tuple(torch.where(sel, d, li) * lit for d, li in zip(_FLOOR_DARK, _FLOOR_LIGHT))
    return _merge(best, t, shaded)


def render_scene_plain(scene: Scene, cam_pos: torch.Tensor, cam_R: torch.Tensor,
                       grid: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size, size, 3) uint8 frames of one camera per env: cam_pos (N, 3),
    cam_R (N, 3, 3), grid (2, size * size) = the camera's (gx, gy)."""
    gx, gy = grid[0], grid[1]
    # world-frame directions: cam_R @ (gx, gy, -1), normalized; (N, P)
    d = [cam_R[:, i, 0:1] * gx + cam_R[:, i, 1:2] * gy - cam_R[:, i, 2:3] for i in range(3)]
    inv = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dx, dy, dz = d[0] * inv, d[1] * inv, d[2] * inv
    rays = (cam_pos[:, 0:1], cam_pos[:, 1:2], cam_pos[:, 2:3], dx, dy, dz)

    # sky background (framebuffer init), gradient on ray elevation
    tsky = torch.clamp(dz * 0.5 + 0.5, 0.0, 1.0)
    k = RENDER_CONSTANTS
    best = (torch.full_like(dx, BIG),) + tuple(float(k[4 + i]) + tsky * float(k[7 + i])
                                              for i in range(3))
    best = _render_plane(best, rays)
    for i in range(N_SPH):
        best = _render_sphere(best, rays, scene.sph_c[:, i], scene.sph_r[i], scene.sph_col[i])
    for i in range(N_CAP):
        best = _render_capsule(best, rays, scene.cap_a[:, i], scene.cap_b[:, i], scene.cap_r[i],
                               scene.cap_col[i])
    for i in range(N_BOX):
        best = _render_box(best, rays, scene.box_c[:, i], scene.box_R[:, i], scene.box_h[i],
                           scene.box_col[i])
    img = torch.clamp(torch.stack(best[1:], -1), 0.0, 1.0)
    return (img * 255.0).to(torch.uint8).reshape(-1, size, size, 3)


def render_cameras_plain(state: engine.PhysicsState, size: int = 128):
    """(front, wrist) (N, size, size, 3) uint8 frames, in plain PyTorch."""
    scene = build_scene(state)
    pos, rot = camera_poses(state)
    grid = pixel_grid(size, state.qpos.device)
    return tuple(render_scene_plain(scene, pos[:, c], rot[:, c], grid[c], size) for c in (0, 1))


# ---------------------------------------------------------------- kernel


def pack_scene(state: engine.PhysicsState) -> torch.Tensor:
    """(N, SCENE_FLOATS) contiguous fp32: each env's two camera poses and
    primitives, in render.cuh's layout."""
    s = build_scene(state)
    pos, rot = camera_poses(state)
    n = pos.shape[0]
    per_env = lambda x: x.expand((n,) + tuple(x.shape)).reshape(n, x.shape[0], -1)
    parts = [torch.cat([pos, rot.reshape(n, 2, 9)], -1).reshape(n, -1),
             torch.cat([s.sph_c, per_env(s.sph_r), per_env(s.sph_col)], -1).reshape(n, -1),
             torch.cat([s.cap_a, s.cap_b, per_env(s.cap_r), per_env(s.cap_col)], -1).reshape(n, -1),
             torch.cat([s.box_c, s.box_R.reshape(n, N_BOX, 9), per_env(s.box_h),
                        per_env(s.box_col)], -1).reshape(n, -1)]
    return torch.cat(parts, -1).contiguous()


# Layout of the kernel's constant row: (name, array), in the order of the
# C_* offsets in csrc/render.cuh.
def _kernel_constant_table():
    return (
        ("BODY_POS", BODY_POS), ("BODY_RMAT", BODY_RMAT),
        ("PINCH_POS", PINCH_POS_L7), ("PINCH_RMAT", PINCH_RMAT_L7),
        ("Y_POLY", gripper.Y_POLY), ("Z_POLY", gripper.Z_POLY),
        ("PAD_HALF_Y", gripper.PAD_HALF_Y), ("PAD_BOX_DZ", gripper.PAD_BOX_DZ),
        ("WRIST_END", _WRIST_END), ("HAND", _HAND),
        ("ATT_R", _ATT_R_L7), ("ATT_POS", _ATT_POS_L7),
        ("WRIST_R", _WRIST_R_ATT), ("WRIST_POS", _WRIST_POS_ATT),
        ("FRONT_POS", _FRONT_POS), ("FRONT_R", _FRONT_R),
        ("SPH_R", _SPH_R), ("SPH_COL", _SPH_COL), ("CAP_R", _CAP_R), ("CAP_COL", _CAP_COL),
        ("BOX_H", _BOX_H), ("BOX_COL", _BOX_COL), ("RENDER", RENDER_CONSTANTS),
    )


def kernel_constants() -> np.ndarray:
    """The kernel's constant row as one flat float32 array."""
    return np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for _, a in _kernel_constant_table()])


@functools.lru_cache(maxsize=None)
def _kernel_constants_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kernel_constants(), device=device)


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C ABI of a build of csrc/render.cu and check that it reads
    this module's layouts."""
    lib.serl_render_cameras.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.serl_render_cameras.restype = ctypes.c_int
    for fn in (lib.serl_render_scene_floats, lib.serl_render_constant_count,
               lib.serl_render_work_floats):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.serl_render_error_string.argtypes = [ctypes.c_int]
    lib.serl_render_error_string.restype = ctypes.c_char_p
    if lib.serl_render_scene_floats() != SCENE_FLOATS:
        raise RuntimeError(f"render kernel writes {lib.serl_render_scene_floats()} scene floats, "
                           f"pack_scene packs {SCENE_FLOATS}")
    if lib.serl_render_constant_count() != kernel_constants().size:
        raise RuntimeError(f"render kernel reads {lib.serl_render_constant_count()} constants, "
                           f"the table packs {kernel_constants().size}")
    return lib


@functools.lru_cache(maxsize=None)
def _render_library():
    """Build (once per source hash) and bind the render kernel."""
    from serl_tpu_torch.native.build import load_library

    return bind_library(load_library("render"))


_STATE_FIELDS = {"qpos": (7,), "theta": (), "cube_pos": (3,), "cube_quat": (4,)}


def render_cameras_cuda(state: engine.PhysicsState, size: int = 128, scene_out=None, lib=None):
    """`render_cameras_plain` by the CUDA kernels: both cameras of every env
    from the physics state, a scene launch then a pixel launch. `scene_out`, an (N, SCENE_FLOATS)
    fp32 CUDA tensor, also receives the scene rows the kernel computed (what
    `pack_scene` packs); `lib` is another build of render.cu bound by
    `bind_library` (chip_smoke.py times two)."""
    device = state.qpos.device
    if device.type != "cuda":
        raise ValueError(f"render_cameras_cuda needs CUDA tensors, got {device}")
    n = state.qpos.shape[0]
    for name, shape in _STATE_FIELDS.items():
        x = getattr(state, name)
        if (x.dtype != torch.float32 or x.device != device or tuple(x.shape) != (n,) + shape
                or not x.is_contiguous()):
            raise ValueError(f"PhysicsState.{name}: want contiguous float32 {(n,) + shape} on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if scene_out is not None and (scene_out.dtype != torch.float32 or scene_out.device != device
                                  or tuple(scene_out.shape) != (n, SCENE_FLOATS)
                                  or not scene_out.is_contiguous()):
        raise ValueError(f"scene_out: want contiguous float32 ({n}, {SCENE_FLOATS}) on {device}")
    size = int(size)
    grid = pixel_grid(size, device)
    consts = _kernel_constants_on(device)
    lib = lib or _render_library()
    front = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    wrist = torch.empty_like(front)
    work = torch.empty((n, lib.serl_render_work_floats()), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.serl_render_cameras(
            *(getattr(state, name).data_ptr() for name in _STATE_FIELDS), consts.data_ptr(),
            grid.data_ptr(), front.data_ptr(), wrist.data_ptr(), work.data_ptr(),
            None if scene_out is None else scene_out.data_ptr(), n, size * size, consts.numel(),
            stream)
    if rc != 0:
        raise RuntimeError(f"render kernel launch failed: {lib.serl_render_error_string(rc).decode()}")
    render_cameras.launches += 2  # the scene kernel, then the pixel kernel
    return front, wrist


def render_cameras(state: engine.PhysicsState, size: int = 128):
    """K2: (front, wrist) (N, size, size, 3) uint8 frames of every env. CPU
    tensors take the plain version; CUDA tensors launch the kernel, or raise."""
    if state.qpos.device.type == "cpu":
        return render_cameras_plain(state, size)
    return render_cameras_cuda(state, size)


render_cameras.launches = 0
