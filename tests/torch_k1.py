"""Checks of the control-step kernel (K1), shared by chip_smoke.py and the tests.

  * state builders: reset states, rollout states (cubes resting on the floor,
    so floor contacts are active), grasp states (the cube pressed between
    the pads, so every pad contact is active) and bin states (the cube
    pressed into the bin walls, so obstacle contacts are active);
  * the tolerance rule by which two float32 implementations of one control
    step are held to each other, per env and PhysicsState field;
  * host builds of csrc/control_step.cuh: the kernel's arithmetic compiled
    with g++ for the CPU, its lanes run as a loop (`host_step`), and the same
    code with a counting float type (`op_counts`, `path_counts`), which gives
    K1's bound its operation count and its critical path.

It imports torch, numpy and serl_tpu_torch only, never JAX: chip_smoke.py
loads it on a machine that has no JAX.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from serl_tpu_torch.envs.panda_pick import ACTION_SCALE, CARTESIAN_BOUNDS, PandaPickCubeEnv
from serl_tpu_torch.envs.physics import arm, engine, gripper
from serl_tpu_torch.envs.physics.math3d import mat_to_quat

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "serl_tpu_torch", "csrc")
BUILD_DIR = os.path.join(HERE, "_build")

# ---------------------------------------------------------------- tolerances

# Two float32 implementations of one control step (the kernel against
# control_step_plain, or the port against the JAX package) are compared per
# env and field, as the max abs difference over the field's components. Env
# e's field f is allowed
#     min(STEP_ATOL[f] + 3 * spread[e, f], STEP_CAP[f]),
# where spread is the distance between float32 and float64 runs of the plain
# version from the same state: what float32 rounding alone does to that env.
# STEP_ATOL is what well-conditioned envs need. At most n_envs // 100 envs may
# exceed it, and none may exceed STEP_CAP.
#
# The exception exists because the model has a discontinuity of its own. The
# controller holds the pinch near its 180-degree target, where w is near 0,
# and math3d.mat_to_quat takes the sign of each small quaternion component
# from an off-diagonal difference of size 4*w*x_i. Float32 rounding can flip
# that sign, and a flipped sign moves the orientation error by twice the
# component. The kp_ori = 200 controller turns this into a qvel jump of up to
# ~0.06 rad/s in one control step. In rollout states it hit 0 to 3 of 2,048
# envs (g++ build of the kernel's code against the plain version, seeds 0-2).
# The JAX package has the same discontinuity. A fault in the kernel shifts
# every env instead. A kernel that drops the arm's contact reaction (J^T
# wrench) misses STEP_ATOL's qvel in every grasp env.
STEP_ATOL = {
    "qpos": 5e-5, "qvel": 2e-3, "theta": 5e-6, "dtheta": 1e-3,
    "grip_ctrl": 0.0, "mocap_pos": 0.0, "mocap_quat": 0.0,
    "cube_pos": 1e-6, "cube_quat": 5e-5, "cube_linvel": 2e-4, "cube_angvel": 3e-2,
}
STEP_CAP = {
    "qpos": 2e-3, "qvel": 1e-1, "theta": 2e-5, "dtheta": 2e-3,
    "grip_ctrl": 0.0, "mocap_pos": 0.0, "mocap_quat": 0.0,
    "cube_pos": 2e-5, "cube_quat": 2e-4, "cube_linvel": 2e-3, "cube_angvel": 1e-1,
}
# A 100-control-step rollout under random actions from reset states, for the
# arm that the controller holds: joint angles (rad) and the pinch (TCP)
# position (m), under the same rule. The cube's fields are not bounded there:
# once the arm pushes the cube, contact is chaotic, and the cube's divergence
# says nothing about either implementation.
DRIFT_ATOL = {"qpos": 1e-2, "tcp_pos": 2e-3}
DRIFT_CAP = {"qpos": 2e-2, "tcp_pos": 4e-3}


def per_env_errors(a, b) -> Dict[str, torch.Tensor]:
    """Per field, the (N,) max abs difference of two states, in float64."""
    n = a.qpos.shape[0]
    return {f: (getattr(a, f).double() - getattr(b, f).double()).abs().reshape(n, -1).amax(1)
            for f in a._fields}


def judge(err: Dict[str, torch.Tensor], spread: Optional[Dict[str, torch.Tensor]],
          atol: Dict[str, float], cap: Dict[str, float]) -> Tuple[List[str], dict]:
    """The tolerance rule above. Returns (failures, summary); the summary
    holds each field's max error and how many envs used the exception."""
    n = next(iter(err.values())).numel()
    outlier = torch.zeros(n, dtype=torch.bool, device=next(iter(err.values())).device)
    failures, max_err = [], {}
    for f, a in atol.items():
        e = err[f]
        slack = 3.0 * spread[f] if spread is not None else torch.zeros_like(e)
        outlier |= ~(e <= torch.clamp(a + slack, max=cap[f]))  # a NaN error is an outlier
        max_err[f] = float(e.max())
        if not max_err[f] <= cap[f]:
            failures.append(f"{f} differs by {max_err[f]:.3g} > cap {cap[f]:.3g}")
    budget = n // 100
    if int(outlier.sum()) > budget:
        failures.append(f"{int(outlier.sum())} of {n} envs exceed the tight tolerance "
                        f"(at most {budget} may)")
    return failures, {"max_err": max_err, "envs_over_atol": int(outlier.sum()), "budget": budget}


# ---------------------------------------------------------------- states


def to_f64(s):
    return type(s)(*(x.double() for x in s))


def reset_states(n: int, g: torch.Generator, device):
    return PandaPickCubeEnv(device=device).reset(n, g)[0].physics


def apply_action(s, a):
    """The env's action semantics on a PhysicsState (panda_pick._step_state)."""
    lo = torch.as_tensor(CARTESIAN_BOUNDS[0], device=a.device, dtype=a.dtype)
    hi = torch.as_tensor(CARTESIAN_BOUNDS[1], device=a.device, dtype=a.dtype)
    a = torch.clamp(a, -1.0, 1.0)
    mocap = torch.clamp(s.mocap_pos + a[:, :3] * float(ACTION_SCALE[0]), lo, hi)
    grip = torch.clamp(s.grip_ctrl / 255.0 + a[:, 3], 0.0, 1.0) * 255.0
    return s._replace(mocap_pos=mocap, grip_ctrl=grip)


def rollout_states(n: int, g: torch.Generator, device, steps: int = 30):
    """Reset states advanced by the plain version under random actions."""
    s = reset_states(n, g, device)
    for _ in range(steps):
        a = 2.0 * torch.rand((n, 4), generator=g, device=device) - 1.0
        s = engine.control_step_plain(apply_action(s, a))
    return s


def grasp_states(n: int, g: torch.Generator, device):
    """Envs holding the cube between the pads: the arm near home with a
    nonzero joint velocity, the cube aligned with the pinch frame and centred
    between the pads, and theta mid-range so that each pad face presses
    0.5-4 mm into the cube."""
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    s = reset_states(n, g, device)
    q = s.qpos + 0.15 * (2.0 * u(n, 7) - 1.0)
    kin = arm.fk(q)
    grid = torch.linspace(0.0, float(gripper.THETA_HI), 801, device=device)
    y_face = gripper.polyval(gripper.Y_POLY, grid) - gripper.PAD_HALF_Y  # decreasing
    depth = 0.0005 + 0.0035 * u(n)
    idx = torch.searchsorted(-y_face, -(float(engine.CUBE_HALF[1]) - depth))
    theta = grid[idx.clamp(max=grid.numel() - 1)]
    z = gripper.polyval(gripper.Z_POLY, theta)
    centre = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
    cube_pos = kin.pinch_pos + (kin.pinch_rmat @ centre[..., None])[..., 0]
    return s._replace(
        qpos=q.contiguous(),
        qvel=0.05 * (2.0 * u(n, 7) - 1.0),
        theta=theta.contiguous(),
        grip_ctrl=torch.full_like(theta, 255.0),
        mocap_pos=kin.pinch_pos.contiguous(),
        cube_pos=cube_pos.contiguous(),
        cube_quat=mat_to_quat(kin.pinch_rmat).contiguous(),
        cube_linvel=0.02 * (2.0 * u(n, 3) - 1.0),
        cube_angvel=0.1 * (2.0 * u(n, 3) - 1.0),
    )


def bin_states(n: int, g: torch.Generator, device) -> Dict[str, engine.PhysicsState]:
    """Reset states with the cube moved against the bin walls of
    envs/tasks.py::bin_walls, per env at a random wall or bin: "wall" (pressed
    0.2-2 mm into a wall's inner face, resting on the floor, yawed up to
    +-0.1 rad), "corner" (into a bin's corner, two walls), "top" (over a
    wall's top, one column of corners sunk into it, tilted up to 0.1 rad,
    moving at up to 0.2 m/s, as when carried over it), "edge" (a corner
    column inside the wall at its top inner edge, 0.2-3 mm from the top and
    from the side, axis-aligned: depths near a tie between the axes)."""
    from serl_tpu_torch.envs import tasks
    from serl_tpu_torch.envs.physics.math3d import quat_from_axis_angle

    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    pick = lambda k: torch.randint(0, k, (n,), generator=g, device=device)
    half = float(engine.CUBE_HALF[0])
    h, t, top = tasks.BIN_HALF, tasks.WALL_THICKNESS, tasks.WALL_HEIGHT
    centres = torch.tensor([tasks.FW_BIN, tasks.BW_BIN], device=device)[pick(2)]  # (n, 2)
    cx, cy = centres[:, 0], centres[:, 1]
    inner = h - half  # the cube centre's reach from the bin centre before it touches a wall
    out = {}

    def state(pos, axis, angle, linvel):
        s = reset_states(n, g, device)
        return s._replace(cube_pos=pos.contiguous(),
                          cube_quat=quat_from_axis_angle(axis, angle).contiguous(),
                          cube_linvel=linvel.contiguous(),
                          cube_angvel=(0.5 * (2.0 * u(n, 3) - 1.0)).contiguous())

    z_axis = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)
    rest_z = torch.full((n,), half - 1e-4, device=device)
    # a wall: k 0/1 the low/high y wall, 2/3 the low/high x wall
    k, pen, along = pick(4), 0.0002 + 0.0018 * u(n), (2.0 * u(n) - 1.0) * inner
    side = torch.where(k % 2 == 0, -1.0, 1.0)
    off = side * (inner + pen)
    x = torch.where(k >= 2, cx + off, cx + along)
    y = torch.where(k >= 2, cy + along, cy + off)
    toward = torch.stack([torch.where(k >= 2, side, 0.0), torch.where(k >= 2, 0.0, side),
                          torch.zeros_like(side)], -1)
    out["wall"] = state(torch.stack([x, y, rest_z], -1), z_axis, 0.1 * (2.0 * u(n) - 1.0),
                        0.05 * u(n)[:, None] * toward)
    sx, sy = torch.where(u(n) < 0.5, -1.0, 1.0), torch.where(u(n) < 0.5, -1.0, 1.0)
    pos = torch.stack([cx + sx * (inner + 0.0002 + 0.0018 * u(n)),
                       cy + sy * (inner + 0.0002 + 0.0018 * u(n)), rest_z], -1)
    out["corner"] = state(pos, z_axis, 0.1 * (2.0 * u(n) - 1.0),
                          0.05 * torch.stack([sx, sy, torch.zeros_like(sx)], -1))
    # over a wall's top: the wall's mid-plane at c -+ (h + t / 2); the cube's
    # centre half - t / 2 off it, so one column of corners lies over the wall
    k, pen = pick(4), 0.0002 + 0.0018 * u(n)
    side = torch.where(k % 2 == 0, -1.0, 1.0)
    off = side * (h + 0.5 * t) + torch.where(u(n) < 0.5, -1.0, 1.0) * (half - 0.25 * t)
    along = (2.0 * u(n) - 1.0) * inner
    x = torch.where(k >= 2, cx + off, cx + along)
    y = torch.where(k >= 2, cy + along, cy + off)
    axis = 2.0 * u(n, 3) - 1.0
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    out["top"] = state(torch.stack([x, y, top + half - pen], -1), axis, 0.1 * u(n),
                       0.2 * (2.0 * u(n, 3) - 1.0))
    # at a wall's top inner edge: a column of corners pen_side inside the
    # inner face and pen_top below the top
    k = pick(4)
    side = torch.where(k % 2 == 0, -1.0, 1.0)
    pen_side, pen_top = 0.0002 + 0.0028 * u(n), 0.0002 + 0.0028 * u(n)
    off = side * (h + pen_side - half)
    along = (2.0 * u(n) - 1.0) * inner
    x = torch.where(k >= 2, cx + off, cx + along)
    y = torch.where(k >= 2, cy + along, cy + off)
    out["edge"] = state(torch.stack([x, y, top - pen_top + half], -1), z_axis,
                        torch.zeros(n, device=device), 0.02 * (2.0 * u(n, 3) - 1.0))
    return out


def compare_step(step, s, obstacles=None):
    """One control step by `step` (the kernel, or its host build) against
    control_step_plain in float32 (against the (M, 2, 3) `obstacles` where
    given), with the plain version's float64 run as the measure of rounding;
    returns (failures, summary, errors per env)."""
    if obstacles is None:
        got, want = step(s), engine.control_step_plain(s)
    else:
        got, want = step(s, obstacles), engine.control_step_plain(s, obstacles)
    err = per_env_errors(got, want)
    spread = per_env_errors(want, engine.control_step_plain(to_f64(s), obstacles))
    failures, summary = judge(err, spread, STEP_ATOL, STEP_CAP)
    return failures, summary, err


# ---------------------------------------------------------------- host builds


def _compiler() -> str:
    for name in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH)")


@functools.lru_cache(maxsize=None)
def _host_library(count_ops: bool, csrc: str, ascending: bool = False,
                  no_obstacles: bool = False) -> ctypes.CDLL:
    source = os.path.join(HERE, "k1_host.cpp")
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
    if count_ops:
        flags.append("-DSERL_COUNT_OPS")
    if ascending:
        flags.append("-DSERL_HOST_ASCENDING")
    if no_obstacles:
        flags.append("-DSERL_NO_OBSTACLES")
    h = hashlib.sha256(" ".join(flags + [os.path.abspath(csrc)]).encode())
    for path in (source, os.path.join(csrc, "control_step.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    name = ("count" if count_ops else "step-up" if ascending else "step") + (
        "-noobs" if no_obstacles else "")
    out = os.path.join(BUILD_DIR, f"libk1_{name}-{h.hexdigest()[:16]}.so")
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
        # fields, consts, obstacles, m, n, ops, path
        lib.k1_count_ops.argtypes = [ptr, ptr, ptr, n, n, ptr, ptr]
        lib.k1_count_ops.restype = None
    else:
        lib.k1_host_step.argtypes = [ptr, ptr, ptr, ptr, n, n]  # in, out, consts, obstacles, m, n
        lib.k1_host_step.restype = None
        lib.k1_div_mismatches.argtypes = [ctypes.c_int64, ctypes.c_uint32]
        lib.k1_div_mismatches.restype = ctypes.c_int64
    return lib


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _boxes(obstacles) -> Tuple[np.ndarray, int]:
    """(contiguous float32 table, M) of an obstacle table or None."""
    if obstacles is None:
        return np.zeros(6, np.float32), 0
    boxes = np.ascontiguousarray(engine.obstacle_table(obstacles, "cpu").numpy())
    return boxes, boxes.shape[0]


def host_step(s, obstacles=None, csrc: str = CSRC, ascending: bool = False,
              no_obstacles: bool = False):
    """One control step of CPU state `s` against the (M, 2, 3) `obstacles`
    by the kernel's code built for the CPU (`csrc` names another copy of the
    header, for a planted fault), its lanes run from the last to the first,
    or from the first to the last; `no_obstacles` builds the header with its
    obstacle code compiled out (SERL_NO_OBSTACLES)."""
    lib = _host_library(False, csrc, ascending, no_obstacles)
    engine._check_state(s)
    if s.qpos.device.type != "cpu":
        raise ValueError(f"host_step needs CPU tensors, got {s.qpos.device}")
    out = [torch.empty_like(x) for x in s]
    consts = engine.kernel_constants()
    boxes, m = _boxes(obstacles)
    lib.k1_host_step(_pointers(list(s)), _pointers(out), consts.ctypes.data, boxes.ctypes.data, m,
                     s.qpos.shape[0])
    return engine.PhysicsState(*out)


def div_mismatches(n: int, seed: int = 0) -> int:
    """Quotients of the kernel's division by a reciprocal (control_step.cuh's
    div_rcp) that differ from x / d in any bit, over n random pairs, each
    pair taken twice (k1_host.cpp::k1_div_mismatches says how)."""
    return int(_host_library(False, CSRC).k1_div_mismatches(n, seed))


def op_and_path_counts(s, obstacles=None) -> Tuple[np.ndarray, np.ndarray]:
    """(N,) float32 operations that each env's control step (against the
    (M, 2, 3) `obstacles`, if given) executes in the kernel's code, and (N,)
    its critical path (per phase the most operations of any one lane, summed
    over phases and substeps), counted as k1_host.cpp says; `s` may lie on
    any device."""
    lib = _host_library(True, CSRC)
    s = engine.PhysicsState(*(x.detach().to("cpu", torch.float32).contiguous() for x in s))
    engine._check_state(s)
    n = s.qpos.shape[0]
    ops, path = np.zeros(n, np.int64), np.zeros(n, np.int64)
    consts = engine.kernel_constants()
    boxes, m = _boxes(None if obstacles is None else torch.as_tensor(obstacles).cpu())
    lib.k1_count_ops(_pointers(list(s)), consts.ctypes.data, boxes.ctypes.data, m, n,
                     ops.ctypes.data, path.ctypes.data)
    return ops, path


def op_counts(s, obstacles=None) -> np.ndarray:
    """(N,) float32 operations of each env's control step (K1's bound)."""
    return op_and_path_counts(s, obstacles)[0]
