# A frozen copy of serl_tpu_torch/envs/physics/arm.py at commit 89bf89d,
# its CUDA binding left out: the benchmark's plain reference of the env.
"""Batched Panda arm kinematics and dynamics (plain PyTorch).

Port of `serl_tpu/envs/physics/arm.py`: forward kinematics of the 7-R chain,
the pinch-site Jacobian, the mass matrix by the Composite Rigid Body
Algorithm and the bias forces by the Recursive Newton-Euler Algorithm, all in
world-origin spatial coordinates. Every function takes any leading batch
shape (the env axis) in place of the JAX package's per-env `vmap`.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.env import panda_model as pm
from benchmark.reference.env.math3d import (
    cross,
    crf,
    crm,
    f32_precision,
    quat_to_mat_np,
    spatial_inertia,
)

NL = pm.NUM_LINKS  # 7

BODY_POS = np.asarray(pm.BODY_POS, np.float32)
BODY_RMAT = np.stack([quat_to_mat_np(q) for q in pm.BODY_QUAT])
BODY_MASS = np.asarray(pm.BODY_MASS, np.float32)
BODY_IPOS = np.asarray(pm.BODY_IPOS, np.float32)
BODY_INERTIA = np.asarray(pm.BODY_INERTIA, np.float32)
ARMATURE = np.asarray(pm.JOINT_ARMATURE, np.float32)
PINCH_POS_L7 = np.asarray(pm.PINCH_POS_L7, np.float32)
PINCH_RMAT_L7 = quat_to_mat_np(pm.PINCH_QUAT_L7)
GRAVITY = np.asarray(pm.GRAVITY, np.float32)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, dtype: torch.dtype = torch.float32):
    """The model constants as tensors on `device` (made once per dtype)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "body_pos": t(BODY_POS),
        "body_rmat": t(BODY_RMAT),
        "mass": t(BODY_MASS[1:]),
        "ipos": t(BODY_IPOS[1:]),
        "inertia": t(BODY_INERTIA[1:]),
        "armature_diag": torch.diag(t(ARMATURE)),
        "pinch_pos": t(PINCH_POS_L7),
        "pinch_rmat": t(PINCH_RMAT_L7),
        "a0": t(np.concatenate([np.zeros(3, np.float32), -GRAVITY])),
    }


class ArmKin(NamedTuple):
    """World-frame kinematics of the chain (leading batch axes first)."""

    p: torch.Tensor  # (..., 8, 3) link frame origins (link0..link7)
    R: torch.Tensor  # (..., 8, 3, 3) link orientations
    axes: torch.Tensor  # (..., 7, 3) world joint axes (local +z of links 1..7)
    pinch_pos: torch.Tensor  # (..., 3)
    pinch_rmat: torch.Tensor  # (..., 3, 3)


def rotate_by(R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """R @ C for a batch of (..., 3, 3) rotations R and one constant (3, 3)
    C, as an elementwise product summed over the shared axis. A batched `@`
    against a constant folds the batch into the product's rows, and on the
    card cuBLAS picks its kernel, and so its rounding, by that row count: a
    4-row batch's result differed from the same rows of an 8-row batch's
    (tests/bin_obs_rounding.py). This form rounds each row alike at any row
    count."""
    return (R[..., :, :, None] * C).sum(-2)


@f32_precision
def fk(qpos: torch.Tensor, rows_alike: bool = False) -> ArmKin:
    """Forward kinematics. qpos: (..., 7). With `rows_alike` the products
    by the model's constant rotations are `rotate_by`'s, so that each row
    rounds as it would in a batch of any size: the pose tasks' observations
    and the bin task's reward take it, and a data-parallel rank's rows equal
    one rank's. The physics, the resets and the experts keep the batched
    `@`: their rounding sets the states at which K1 is held to its plain
    version, and a state moved by an ulp can cross `mat_to_quat`'s sign flip
    (tests/torch_k1.py)."""
    c = _consts(qpos.device, qpos.dtype)
    rotate = rotate_by if rows_alike else torch.matmul
    batch = qpos.shape[:-1]
    p = c["body_pos"][0].expand(batch + (3,))
    R = c["body_rmat"][0].expand(batch + (3, 3))
    ps, Rs, axes = [p], [R], []
    zero = torch.zeros_like(qpos[..., 0])
    one = torch.ones_like(zero)
    for i in range(1, NL + 1):
        p = p + R @ c["body_pos"][i]
        R_fixed = rotate(R, c["body_rmat"][i])
        cq, sq = torch.cos(qpos[..., i - 1]), torch.sin(qpos[..., i - 1])
        Rz = torch.stack([cq, -sq, zero, sq, cq, zero, zero, zero, one], -1)
        R = R_fixed @ Rz.reshape(batch + (3, 3))
        ps.append(p)
        Rs.append(R)
        axes.append(R[..., :, 2])
    p = torch.stack(ps, -2)
    R = torch.stack(Rs, -3)
    pinch_pos = p[..., NL, :] + R[..., NL, :, :] @ c["pinch_pos"]
    pinch_rmat = rotate(R[..., NL, :, :], c["pinch_rmat"])
    return ArmKin(p=p, R=R, axes=torch.stack(axes, -2), pinch_pos=pinch_pos,
                  pinch_rmat=pinch_rmat)


def point_jacobian(kin: ArmKin, point: torch.Tensor) -> torch.Tensor:
    """(..., 6, 7) spatial Jacobian [J_w; J_v] of a world point rigidly
    attached to link7: column i = [a_i; a_i x (point - o_i)]."""
    o = kin.p[..., 1:, :]  # (..., 7, 3) joint origins
    a = kin.axes  # (..., 7, 3)
    jv = cross(a, point[..., None, :] - o)
    return torch.cat([a.transpose(-1, -2), jv.transpose(-1, -2)], dim=-2)


def _link_spatial_inertias(kin: ArmKin) -> torch.Tensor:
    """(..., 7, 6, 6) spatial inertia of moving links 1..7 about the origin."""
    c = _consts(kin.p.device, kin.p.dtype)
    R = kin.R[..., 1:, :, :]
    coms = kin.p[..., 1:, :] + (R @ c["ipos"][..., None])[..., 0]
    I_world = R @ c["inertia"] @ R.transpose(-1, -2)
    return spatial_inertia(c["mass"], coms, I_world)


def _motion_subspaces(kin: ArmKin) -> torch.Tensor:
    """(..., 7, 6) Plücker motion subspace per joint: [a; o x a]."""
    o = kin.p[..., 1:, :]
    a = kin.axes
    return torch.cat([a, cross(o, a)], dim=-1)


@f32_precision
def mass_matrix(kin: ArmKin) -> torch.Tensor:
    """(..., 7, 7) joint-space inertia via CRBA in world coordinates, with the
    armature on the diagonal."""
    I_links = _link_spatial_inertias(kin)
    S = _motion_subspaces(kin)
    # composite inertia of the subtree rooted at link i: sum_{j>=i} I_j
    I_comp = torch.flip(torch.cumsum(torch.flip(I_links, [-3]), dim=-3), [-3])
    # F_i = I_comp_i @ S_i ; M[i, j] = S_min(i,j) . F_max(i,j)
    F = (I_comp @ S[..., None])[..., 0]  # (..., 7, 6)
    M_full = S @ F.transpose(-1, -2)  # S_i . F_j, valid where j >= i
    M = torch.triu(M_full) + torch.triu(M_full, 1).transpose(-1, -2)
    return M + _consts(kin.p.device, kin.p.dtype)["armature_diag"]


@f32_precision
def bias_forces(kin: ArmKin, qvel: torch.Tensor) -> torch.Tensor:
    """C(q, qd) qd + g(q) via RNEA (qacc = 0) in world spatial coordinates."""
    I_links = _link_spatial_inertias(kin)
    S = _motion_subspaces(kin)
    # gravity as a fictitious base acceleration: a0 = [0; -g]
    a = _consts(qvel.device, qvel.dtype)["a0"].expand(qvel.shape[:-1] + (6,))
    v = torch.zeros_like(a)
    vs, accs = [], []
    for i in range(NL):
        vJ = S[..., i, :] * qvel[..., i : i + 1]
        v = v + vJ
        a = a + (crm(v) @ vJ[..., None])[..., 0]  # Φ̇ qd term (qacc = 0)
        vs.append(v)
        accs.append(a)
    # link forces: f_i = I_i a_i + crf(v_i) I_i v_i
    f = [
        (I_links[..., i, :, :] @ accs[i][..., None])[..., 0]
        + (crf(vs[i]) @ (I_links[..., i, :, :] @ vs[i][..., None]))[..., 0]
        for i in range(NL)
    ]
    # backward: subtree sums, projected on S
    tau = []
    fC = torch.zeros_like(a)
    for i in reversed(range(NL)):
        fC = fC + f[i]
        tau.append((S[..., i, :] * fC).sum(-1))
    return torch.stack(tau[::-1], dim=-1)


def pinch_velocity(kin: ArmKin, qvel: torch.Tensor):
    """Linear and angular world velocity of the pinch site."""
    J = point_jacobian(kin, kin.pinch_pos)  # (..., 6, 7) [w; v]
    sv = (J @ qvel[..., None])[..., 0]
    return sv[..., 3:], sv[..., :3]
