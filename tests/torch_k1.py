"""Checks of the control-step kernel (K1), shared by chip_smoke.py and the tests.

  * state builders: reset states, rollout states (cubes resting on the floor,
    so floor contacts are active) and grasp states (the cube pressed between
    the pads, so every pad contact is active);
  * the tolerance rule by which two float32 implementations of one control
    step are held to each other, per env and PhysicsState field;
  * host builds of csrc/control_step.cuh: the kernel's arithmetic compiled
    with g++ for the CPU (`host_step`), and the same code with a counting
    float type (`op_counts`), which gives K1's bound its operation count.

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
        outlier |= e > torch.clamp(a + slack, max=cap[f])
        max_err[f] = float(e.max())
        if max_err[f] > cap[f]:
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


def compare_step(step, s):
    """One control step by `step` (the kernel, or its host build) against
    control_step_plain in float32, with the plain version's float64 run as
    the measure of rounding; returns (failures, summary, errors per env)."""
    got, want = step(s), engine.control_step_plain(s)
    err = per_env_errors(got, want)
    spread = per_env_errors(want, engine.control_step_plain(to_f64(s)))
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
def _host_library(count_ops: bool, csrc: str) -> ctypes.CDLL:
    source = os.path.join(HERE, "k1_host.cpp")
    flags = ["-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
    if count_ops:
        flags.append("-DSERL_COUNT_OPS")
    h = hashlib.sha256(" ".join(flags + [os.path.abspath(csrc)]).encode())
    for path in (source, os.path.join(csrc, "control_step.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    name = "count" if count_ops else "step"
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
        lib.k1_count_ops.argtypes = [ptr, ptr, n, ptr]  # fields, consts, n, ops
        lib.k1_count_ops.restype = None
    else:
        lib.k1_host_step.argtypes = [ptr, ptr, ptr, n]  # in, out, consts, n
        lib.k1_host_step.restype = None
    return lib


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def host_step(s, csrc: str = CSRC):
    """One control step of CPU state `s` by the kernel's code built for the
    CPU (`csrc` names another copy of the header, for a planted fault)."""
    lib = _host_library(False, csrc)
    engine._check_state(s)
    if s.qpos.device.type != "cpu":
        raise ValueError(f"host_step needs CPU tensors, got {s.qpos.device}")
    out = [torch.empty_like(x) for x in s]
    consts = engine.kernel_constants()
    lib.k1_host_step(_pointers(list(s)), _pointers(out), consts.ctypes.data, s.qpos.shape[0])
    return engine.PhysicsState(*out)


def op_counts(s) -> np.ndarray:
    """(N,) float32 operations that each env's control step executes in the
    kernel's code, counted as k1_host.cpp says; `s` may lie on any device."""
    lib = _host_library(True, CSRC)
    s = engine.PhysicsState(*(x.detach().to("cpu", torch.float32).contiguous() for x in s))
    engine._check_state(s)
    n = s.qpos.shape[0]
    ops = np.zeros(n, np.int64)
    consts = engine.kernel_constants()
    lib.k1_count_ops(_pointers(list(s)), consts.ctypes.data, n, ops.ctypes.data)
    return ops
