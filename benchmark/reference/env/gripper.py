# A frozen copy of serl_tpu_torch/envs/physics/gripper.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Reduced 1-DoF Robotiq 2F-85 gripper model (plain PyTorch).

Port of `serl_tpu/envs/physics/gripper.py`: one driver DOF `theta` in
[0, 0.8]; the pad pose in the pinch frame comes from cubic fits of the real
linkage, the MuJoCo `fingers_actuator` acts on theta, and contact forces on
the pads feed back through d(pad pos)/d(theta). Batched over leading axes.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.env import panda_model as pm

Y_POLY = np.asarray(pm.PAD_Y_POLY, np.float32)
Z_POLY = np.asarray(pm.PAD_Z_POLY, np.float32)
DY_POLY = np.asarray(
    [3 * pm.PAD_Y_POLY[0], 2 * pm.PAD_Y_POLY[1], pm.PAD_Y_POLY[2]], np.float32
)
DZ_POLY = np.asarray(
    [3 * pm.PAD_Z_POLY[0], 2 * pm.PAD_Z_POLY[1], pm.PAD_Z_POLY[2]], np.float32
)
PAD_HALF_Y = float(np.float32(pm.PAD_HALF[1]))

# two stacked pad boxes per finger (pad1 above pad2); the y/z polynomials
# track the mean of both boxes, which sit +-0.009375 apart along z.
PAD_BOX_DZ = (+0.009375, -0.009375)

# effective reduced-coordinate dynamics parameters (driver pair + linkage)
INERTIA = 0.012  # 2x driver armature 0.005 + finger link inertia
DAMPING = 0.2  # 2x driver joint damping 0.1
SPRING_K = 0.1  # 2x spring_link stiffness 0.05
SPRING_REF = 2.62  # springref (rad), biases toward closing

GAIN = float(pm.GRIPPER_GAIN)
BIAS_KP = float(pm.GRIPPER_BIAS_KP)
BIAS_KV = float(pm.GRIPPER_BIAS_KV)
F_LO = float(pm.GRIPPER_FORCERANGE[0])
F_HI = float(pm.GRIPPER_FORCERANGE[1])
THETA_LO = float(pm.DRIVER_RANGE[0])
THETA_HI = float(pm.DRIVER_RANGE[1])


class PadKin(NamedTuple):
    """Pad contact-point kinematics in the pinch frame."""

    points: torch.Tensor  # (..., 4, 3): [right_pad1, right_pad2, left_pad1, left_pad2]
    normals: torch.Tensor  # (4, 3): inward normals (toward the grip axis)
    dpoint_dtheta: torch.Tensor  # (..., 4, 3): d(point)/d(theta)


def polyval(coeffs, x):
    """Horner's rule, highest power first (the order `jnp.polyval` uses)."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + float(c)
    return y


def pad_kinematics(theta: torch.Tensor) -> PadKin:
    """Pad contact points/normals/jacobians in the pinch frame. theta: (...)."""
    y = polyval(Y_POLY, theta)
    z = polyval(Z_POLY, theta)
    dy = polyval(DY_POLY, theta)
    dz = polyval(DZ_POLY, theta)
    y_face = y - PAD_HALF_Y  # inner face of the pad box
    zero = torch.zeros_like(y)
    pts, jacs = [], []
    for side in (+1.0, -1.0):  # right (+y), left (-y)
        for dzb in PAD_BOX_DZ:
            pts.append(torch.stack([zero, side * y_face, z + dzb], -1))
            jacs.append(torch.stack([zero, side * dy, dz], -1))
    return PadKin(
        points=torch.stack(pts, -2),
        normals=_pad_normals(theta.device, theta.dtype),
        dpoint_dtheta=torch.stack(jacs, -2),
    )


@functools.lru_cache(maxsize=None)
def _pad_normals(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(4, 3) inward pad normals, made once per device (no copy per call)."""
    norms = [[0.0, -side, 0.0] for side in (+1.0, -1.0) for _ in PAD_BOX_DZ]
    return torch.tensor(norms, dtype=dtype, device=device)


def actuator_force(ctrl, theta, dtheta):
    """MuJoCo general-actuator force on the driver tendon. ctrl in [0, 255]."""
    f = GAIN * ctrl - BIAS_KP * theta - BIAS_KV * dtheta
    return torch.clamp(f, F_LO, F_HI)


def step_theta(theta, dtheta, ctrl, contact_torque, dt: float):
    """Semi-implicit Euler on the reduced finger DOF."""
    f_act = actuator_force(ctrl, theta, dtheta)
    f_spring = SPRING_K * (SPRING_REF - theta)
    acc = (f_act + f_spring - DAMPING * dtheta + contact_torque) / INERTIA
    new_dtheta = dtheta + dt * acc
    new_theta = theta + dt * new_dtheta
    # joint-range clamp with velocity kill at the stops
    clamped = torch.clamp(new_theta, THETA_LO, THETA_HI)
    new_dtheta = torch.where(clamped == new_theta, new_dtheta, torch.zeros_like(new_dtheta))
    return clamped, new_dtheta
