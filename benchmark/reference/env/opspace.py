# A frozen copy of serl_tpu_torch/envs/physics/opspace.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Batched operational-space torque controller (plain PyTorch).

Port of `serl_tpu/envs/physics/opspace.py`: task-space PD with critical
damping, task-space inertia weighting, nullspace joint PD and gravity
compensation. `M^{-1} J^T` comes from Cholesky solves, and the reference's
det-threshold pinv fallback is a Tikhonov-damped inverse whose damping is
raised near singularity.
"""

import functools

import numpy as np
import torch

from benchmark.reference.env import panda_model as pm
from benchmark.reference.env.arm import ArmKin, point_jacobian
from benchmark.reference.env.linalg_small import det_spd, inv_spd, solve_spd_mat
from benchmark.reference.env.math3d import (
    f32_precision,
    mat_to_quat,
    quat_conj,
    quat_mul,
    quat_to_axis_angle,
)

TORQUE_LO = np.asarray(pm.TORQUE_LIMIT, np.float32)[:, 0]
TORQUE_HI = np.asarray(pm.TORQUE_LIMIT, np.float32)[:, 1]
Q_HOME = np.asarray(pm.PANDA_HOME, np.float32)


def critical_damping(kp: float) -> float:
    """kd = 2 sqrt(kp) (damping ratio 1), rounded to float32 as the JAX
    package computes it."""
    return float(np.float32(2.0) * np.sqrt(np.float32(kp)))


# controller gains of the env: position, orientation and nullspace PD
KP_POS, KP_ORI, KP_NULL = 200.0, 200.0, 0.5
KD_POS, KD_ORI, KD_NULL = (critical_damping(k) for k in (KP_POS, KP_ORI, KP_NULL))
# det(J M^-1 J^T) below DET_THRESHOLD selects the larger Tikhonov damping
DET_THRESHOLD = 1e-2
EPS_SINGULAR = 1e-2
EPS_REGULAR = 1e-6


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, dtype: torch.dtype = torch.float32):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {"lo": t(TORQUE_LO), "hi": t(TORQUE_HI), "q_home": t(Q_HOME),
            "eye6": torch.eye(6, dtype=dtype, device=device),
            "eye7": torch.eye(7, dtype=dtype, device=device)}


@f32_precision
def opspace_torques(
    kin: ArmKin,
    M: torch.Tensor,
    bias: torch.Tensor,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    target_pos: torch.Tensor,
    target_quat: torch.Tensor,
) -> torch.Tensor:
    """Joint torques (..., 7) for a batch of envs, with the env's gains (the
    JAX function's defaults); the nullspace target is the home pose."""
    c = _consts(qpos.device, qpos.dtype)

    J = point_jacobian(kin, kin.pinch_pos)  # (..., 6, 7) [w; v]
    Jw, Jv = J[..., :3, :], J[..., 3:, :]
    mv = lambda A, x: (A @ x[..., None])[..., 0]

    # position PD (reference pd_control)
    x = kin.pinch_pos
    dx = mv(Jv, qvel)
    ddx = -KP_POS * (x - target_pos) - KD_POS * dx

    # orientation PD: active (world-frame) error axisangle(cur * des^-1)
    quat = mat_to_quat(kin.pinch_rmat)
    quat = torch.where((quat * target_quat).sum(-1, keepdim=True) < 0.0, -quat, quat)
    q_err = quat_mul(quat, quat_conj(target_quat))
    ori_err = quat_to_axis_angle(q_err)
    w = mv(Jw, qvel)
    dw = -KP_ORI * ori_err - KD_ORI * w

    # task-space inertia: Mx = (J M^-1 J^T)^-1, damped near singularity
    Jfull = torch.cat([Jv, Jw], dim=-2)  # (..., 6, 7), [v; w] like the reference
    JfT = Jfull.transpose(-1, -2)
    Minv_JT = solve_spd_mat(M, JfT)  # (..., 7, 6)
    Mx_inv = Jfull @ Minv_JT  # (..., 6, 6)
    det = det_spd(Mx_inv)
    eps = torch.where(det.abs() < DET_THRESHOLD, EPS_SINGULAR, EPS_REGULAR)
    Mx = inv_spd(Mx_inv + eps[..., None, None] * c["eye6"])

    ddx_dw = torch.cat([ddx, dw], dim=-1)
    tau = mv(JfT, mv(Mx, ddx_dw))

    # nullspace joint PD
    ddq = -KP_NULL * (qpos - c["q_home"]) - KD_NULL * qvel
    Jnull = Minv_JT @ Mx  # (..., 7, 6)
    tau = tau + mv(c["eye7"] - JfT @ Jnull.transpose(-1, -2), ddq)

    tau = tau + bias  # gravity + Coriolis compensation
    return torch.clamp(tau, c["lo"], c["hi"])
