"""Batched physics engine for the Panda + gripper + cube scene.

Port of `serl_tpu/envs/physics/engine.py`. The state is structure-of-arrays:
each `PhysicsState` field carries a leading env axis N, where the JAX package
vmaps a single-env pytree.

Pipeline per 2 ms substep (10 substeps per 20 ms control step):
  1. arm FK -> mass matrix (CRBA) -> bias forces (RNEA)
  2. contact forces: cube-floor (8 corners), cube-obstacle (8 corners
     against each static box of an (M, 2, 3) table, the bin walls) and
     pad-cube (4 pad points), compliant normal + regularized Coulomb
     friction; reaction wrenches go to
     the arm through the pinch-site Jacobian and to the finger DOF through the
     pad jacobian
  3. operational-space controller torques (opspace.py)
  4. semi-implicit Euler: arm with implicit joint damping ((M + dt*D) solve),
     cube as a free rigid body with a quaternion exp-map

Two implementations of `control_step` sit side by side:
  * `control_step_plain`: the substeps above in plain PyTorch on batched
    tensors. CPU tensors take it; on the card only tests and chip_smoke.py
    call it, to hold the kernel against it.
  * the CUDA kernel in `serl_tpu_torch/csrc/control_step.cu` (a group of 16
    lanes per env that splits each substep's work, all 10 substeps in one
    launch). `control_step` launches it for CUDA tensors and counts the
    launches in `control_step.launches`.
The kernel reads every model and contact constant from one float32 buffer
that `kernel_constants` packs from this module's constants, so the two
cannot drift apart. The obstacle table, shared by every env, goes to the
kernel as a second buffer of M x 6 floats (M <= MAX_OBSTACLES; M = 0, or
`obstacles=None`, runs only the obstacle-free arithmetic, bit for bit that
of the kernel built without obstacle code).
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from serl_tpu_torch.envs.physics import gripper as gr
from serl_tpu_torch.envs.physics import opspace
from serl_tpu_torch.envs.physics import panda_model as pm
from serl_tpu_torch.envs.physics.arm import (
    BODY_INERTIA,
    BODY_IPOS,
    BODY_MASS,
    BODY_POS,
    BODY_RMAT,
    ARMATURE,
    GRAVITY,
    PINCH_POS_L7,
    PINCH_RMAT_L7,
    bias_forces,
    fk,
    mass_matrix,
    pinch_velocity,
    point_jacobian,
)
from serl_tpu_torch.envs.physics.linalg_small import PIVOT_EPS, solve3, solve_spd
from serl_tpu_torch.envs.physics.math3d import (
    cross,
    f32_precision,
    norm,
    quat_integrate,
    quat_to_mat,
)
from serl_tpu_torch.envs.physics.opspace import opspace_torques

# ---- constants ----
DT = 0.002
N_SUBSTEPS = 10

JOINT_DAMPING = np.asarray(pm.JOINT_DAMPING, np.float32)
JNT_LO = np.asarray(pm.JOINT_RANGE, np.float32)[:, 0]
JNT_HI = np.asarray(pm.JOINT_RANGE, np.float32)[:, 1]
Q_HOME = np.asarray(pm.PANDA_HOME, np.float32)
MOCAP_HOME_QUAT = np.asarray(pm.MOCAP_HOME_QUAT, np.float32)

CUBE_MASS = float(pm.BLOCK_MASS)
CUBE_HALF = np.asarray(pm.BLOCK_HALF, np.float32)
# solid box inertia: I = m/12 * (b^2 + c^2) per axis
CUBE_I_DIAG = np.float32(CUBE_MASS / 12.0) * np.asarray(
    [
        (2 * pm.BLOCK_HALF[1]) ** 2 + (2 * pm.BLOCK_HALF[2]) ** 2,
        (2 * pm.BLOCK_HALF[0]) ** 2 + (2 * pm.BLOCK_HALF[2]) ** 2,
        (2 * pm.BLOCK_HALF[0]) ** 2 + (2 * pm.BLOCK_HALF[1]) ** 2,
    ],
    np.float32,
)

# contact parameters. Per-point constants are chosen for semi-implicit-Euler
# stability with several simultaneous points sharing load: need
# (sum kd)*dt/m < ~2 and dt*sqrt(sum kn/m) < ~1.
KN_FLOOR = 1500.0  # x4 corners -> effective 6000 N/m, 0.17 mm static sag
KD_FLOOR = 8.0  # x4 -> 32 N s/m (c*dt/m = 0.64)
MU_FLOOR = 1.0
KN_PAD = 8000.0  # grip at full 5 Nm tendon torque (~45 N/finger) -> ~3 mm
KD_PAD = 10.0
MU_PAD = 0.7
V_EPS = 0.003  # friction regularization velocity (m/s)
# one step of friction must not overshoot the velocity-matching impulse
IMPULSE_CAP = 0.5 * CUBE_MASS
# a pad point counts as over the cube within this slack of its half-size
LATERAL_LIMIT = CUBE_HALF + np.float32(2e-3)

# the most static boxes the kernel takes (control_step.cuh: one lane per cube
# corner loops over them)
MAX_OBSTACLES = 8

# cube corners in the cube frame: (8, 3)
CORNERS = np.asarray(
    [
        [sx * pm.BLOCK_HALF[0], sy * pm.BLOCK_HALF[1], sz * pm.BLOCK_HALF[2]]
        for sx in (-1, 1)
        for sy in (-1, 1)
        for sz in (-1, 1)
    ],
    np.float32,
)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, dtype: torch.dtype = torch.float32):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "damping": t(JOINT_DAMPING),
        "damped_diag": torch.diag(DT * t(JOINT_DAMPING)),
        "lo": t(JNT_LO),
        "hi": t(JNT_HI),
        "q_home": t(Q_HOME),
        "mocap_quat": t(MOCAP_HOME_QUAT),
        "cube_half": t(CUBE_HALF),
        "lateral": t(LATERAL_LIMIT),
        "cube_i": torch.diag(t(CUBE_I_DIAG)),
        "cube_weight": t(np.float32(CUBE_MASS) * GRAVITY),
        "corners": t(CORNERS),
    }


class PhysicsState(NamedTuple):
    """Batched physics state: every field has a leading env axis N."""

    qpos: torch.Tensor  # (N, 7)
    qvel: torch.Tensor  # (N, 7)
    theta: torch.Tensor  # (N,) gripper driver angle
    dtheta: torch.Tensor  # (N,)
    grip_ctrl: torch.Tensor  # (N,) commanded 0..255
    mocap_pos: torch.Tensor  # (N, 3) controller target position
    mocap_quat: torch.Tensor  # (N, 4) controller target orientation
    cube_pos: torch.Tensor  # (N, 3)
    cube_quat: torch.Tensor  # (N, 4)
    cube_linvel: torch.Tensor  # (N, 3)
    cube_angvel: torch.Tensor  # (N, 3) world frame


FIELD_WIDTHS = {"qpos": 7, "qvel": 7, "theta": 0, "dtheta": 0, "grip_ctrl": 0,
                "mocap_pos": 3, "mocap_quat": 4, "cube_pos": 3, "cube_quat": 4,
                "cube_linvel": 3, "cube_angvel": 3}  # 0 = one scalar per env


def init_state(cube_xy: torch.Tensor) -> PhysicsState:
    """Home configuration with each env's cube at (x, y, half_height).
    cube_xy: (N, 2) float32."""
    c = _consts(cube_xy.device, cube_xy.dtype)
    n = cube_xy.shape[0]
    q = c["q_home"].repeat(n, 1)
    zeros = cube_xy.new_zeros((n,))
    return PhysicsState(
        qpos=q,
        qvel=torch.zeros_like(q),
        theta=zeros,
        dtheta=zeros.clone(),
        grip_ctrl=zeros.clone(),
        mocap_pos=fk(q).pinch_pos.contiguous(),
        mocap_quat=c["mocap_quat"].repeat(n, 1),
        cube_pos=torch.cat([cube_xy, c["cube_half"][2:3].expand(n, 1)], -1),
        cube_quat=cube_xy.new_tensor([1.0, 0.0, 0.0, 0.0]).repeat(n, 1),
        cube_linvel=cube_xy.new_zeros((n, 3)),
        cube_angvel=cube_xy.new_zeros((n, 3)),
    )


# ------------------------------------------------------------------ #
# Contacts
# ------------------------------------------------------------------ #


def _friction(fn_mag, vt, mu):
    """Regularized Coulomb friction capped at the velocity-matching impulse."""
    vt_norm = norm(vt, keepdim=True)
    ft_mag = torch.minimum(
        mu * fn_mag[..., None] * torch.tanh(vt_norm / V_EPS),
        IMPULSE_CAP * vt_norm / DT,
    )
    return -ft_mag * vt / torch.clamp(vt_norm, min=1e-9)


def _floor_contact(state: PhysicsState):
    """Cube-floor: 8 corner penalty contacts. Returns (force, torque) on the
    cube about its COM and the (N, 8) mask of active corners."""
    c = _consts(state.cube_pos.device, state.cube_pos.dtype)
    Rc = quat_to_mat(state.cube_quat)
    pos = state.cube_pos[..., None, :]
    corners_w = pos + c["corners"] @ Rc.transpose(-1, -2)  # (N, 8, 3)
    r = corners_w - pos
    v = state.cube_linvel[..., None, :] + cross(state.cube_angvel[..., None, :], r)

    depth = -corners_w[..., 2]  # > 0 when below the floor
    active = depth > 0.0
    fn_mag = torch.where(active, KN_FLOOR * depth - KD_FLOOR * v[..., 2], 0.0)
    fn_mag = torch.clamp(fn_mag, min=0.0)
    zero = torch.zeros_like(fn_mag)
    fn = torch.stack([zero, zero, fn_mag], -1)

    vt = torch.cat([v[..., :2], zero[..., None]], -1)
    f = fn + _friction(fn_mag, vt, MU_FLOOR)
    torque = cross(r, f).sum(-2)
    return f.sum(-2), torque, active


def _obstacle_contact(state: PhysicsState, boxes: torch.Tensor):
    """Cube vs static axis-aligned boxes (bin walls): corner penalty contacts
    with the floor's constants and friction cap. `boxes`: (M, 2, 3) world
    (lo, hi) corners. A cube corner strictly inside a box is pushed out
    through the face of least penetration (the first axis on a tie; along
    +axis where the two faces of that axis are equally near). Returns
    (force, torque) on the cube about its COM and the (N, 8, M) mask of
    corners inside a box."""
    c = _consts(state.cube_pos.device, state.cube_pos.dtype)
    Rc = quat_to_mat(state.cube_quat)
    pos = state.cube_pos[..., None, :]
    corners_w = pos + c["corners"] @ Rc.transpose(-1, -2)  # (N, 8, 3)
    r = corners_w - pos
    v = state.cube_linvel[..., None, :] + cross(state.cube_angvel[..., None, :], r)

    lo, hi = boxes[:, 0], boxes[:, 1]  # (M, 3)
    p = corners_w[..., None, :]  # (N, 8, 1, 3)
    d_lo = p - lo  # (N, 8, M, 3) distance inside from each lo face
    d_hi = hi - p
    inside = ((d_lo > 0.0) & (d_hi > 0.0)).all(-1)  # (N, 8, M)

    depth_axis = torch.minimum(d_lo, d_hi)
    sign = torch.where(d_lo < d_hi, -1.0, 1.0).to(d_lo.dtype)  # toward the nearer face
    ax = torch.argmin(depth_axis, -1, keepdim=True)  # the first minimum on a tie
    depth = torch.where(inside, depth_axis.gather(-1, ax)[..., 0], 0.0)
    normal = torch.zeros_like(d_lo).scatter(-1, ax, sign.gather(-1, ax))  # (N, 8, M, 3)

    vv = v[..., None, :]
    vn = (vv * normal).sum(-1)
    fn_mag = torch.clamp(KN_FLOOR * depth - KD_FLOOR * vn, min=0.0) * inside
    vt = vv - vn[..., None] * normal
    f = fn_mag[..., None] * normal + _friction(fn_mag, vt, MU_FLOOR)  # (N, 8, M, 3)
    torque = cross(r[..., None, :], f).sum((-3, -2))
    return f.sum((-3, -2)), torque, inside


def obstacle_table(obstacles, device) -> torch.Tensor:
    """An (M, 2, 3) obstacle table as a contiguous float32 tensor on `device`."""
    boxes = torch.as_tensor(obstacles, dtype=torch.float32, device=device).contiguous()
    if boxes.dim() != 3 or tuple(boxes.shape[1:]) != (2, 3) or boxes.shape[0] > MAX_OBSTACLES:
        raise ValueError(f"obstacles: want (M <= {MAX_OBSTACLES}, 2, 3), got {tuple(boxes.shape)}")
    return boxes


def _pad_contacts(state: PhysicsState, kin, pinch_v, pinch_w):
    """Pad-cube contacts: per-pad plane vs box along the closing axis.

    Contact normals are pinned to the pad's closing axis. For each of the 4
    pad sample points penetration is the support-slab overlap of the point
    along the pad's inward axis, gated by the point lying inside the
    (slightly expanded) cube.

    Returns (f_cube, tau_cube) on the cube, the reaction wrench
    (f_arm, tau_arm_about_pinch) on the hand, the generalized reaction on the
    finger DOF, and the (N, 4) mask of active pad points.
    """
    c = _consts(state.cube_pos.device, state.cube_pos.dtype)
    pk = gr.pad_kinematics(state.theta)
    RpT = kin.pinch_rmat.transpose(-1, -2)
    pinch = kin.pinch_pos[..., None, :]
    pts_w = pinch + pk.points @ RpT  # (N, 4, 3)
    inward_w = pk.normals @ RpT  # (N, 4, 3) unit, toward the grip axis
    dpt_w = pk.dpoint_dtheta @ RpT  # (N, 4, 3) dp/dtheta in world

    Rc = quat_to_mat(state.cube_quat)
    pos = state.cube_pos[..., None, :]
    u = pts_w - pos  # cube center -> pad point
    xi = u @ Rc  # cube-frame coords
    lateral_ok = (xi.abs() < c["lateral"]).all(-1)

    # outward direction (cube -> pad side) and support-slab penetration
    out_w = -inward_w
    axis_c = (out_w @ Rc).abs()  # |axis| in the cube frame
    support = axis_c @ c["cube_half"]  # (N, 4) cube extent along the axis
    d_axis = (u * out_w).sum(-1)  # signed coord of the point along the axis
    depth = support - d_axis
    active = lateral_ok & (depth > 0.0) & (d_axis > 0.0)

    # velocities
    r_c = pts_w - pos
    v_cube_pt = state.cube_linvel[..., None, :] + cross(state.cube_angvel[..., None, :], r_c)
    r_p = pts_w - pinch
    v_pad_pt = (
        pinch_v[..., None, :]
        + cross(pinch_w[..., None, :], r_p)
        + dpt_w * state.dtheta[..., None, None]
    )
    v_rel = v_pad_pt - v_cube_pt  # pad relative to cube

    # normal force on the PAD along +out_w (pushes the pad away from the cube)
    vn = (v_rel * out_w).sum(-1)
    fn_mag = torch.where(active, KN_PAD * depth - KD_PAD * vn, 0.0)
    fn_mag = torch.clamp(fn_mag, min=0.0)
    f_pad_n = fn_mag[..., None] * out_w

    # friction on the PAD opposing tangential pad-vs-cube motion
    vt = v_rel - vn[..., None] * out_w
    f_pad = f_pad_n + _friction(fn_mag, vt, MU_PAD)  # force ON the pad
    f_cube_pts = -f_pad  # reaction on the cube

    f_cube = f_cube_pts.sum(-2)
    tau_cube = cross(r_c, f_cube_pts).sum(-2)
    f_arm = f_pad.sum(-2)
    tau_arm = cross(r_p, f_pad).sum(-2)
    tau_theta = (f_pad * dpt_w).sum((-2, -1))
    return f_cube, tau_cube, f_arm, tau_arm, tau_theta, active


def active_contacts(state: PhysicsState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 8) active floor corners and (N, 4) active pad points of `state`."""
    kin = fk(state.qpos)
    pinch_v, pinch_w = pinch_velocity(kin, state.qvel)
    return _floor_contact(state)[2], _pad_contacts(state, kin, pinch_v, pinch_w)[5]


def active_obstacle_contacts(state: PhysicsState, obstacles) -> torch.Tensor:
    """(N, 8, M) cube corners of `state` inside each box of `obstacles`."""
    return _obstacle_contact(state, obstacle_table(obstacles, state.cube_pos.device)
                             .to(state.cube_pos.dtype))[2]


# ------------------------------------------------------------------ #
# Stepping (plain version)
# ------------------------------------------------------------------ #


@f32_precision
def substep(state: PhysicsState, obstacles: Optional[torch.Tensor] = None) -> PhysicsState:
    c = _consts(state.qpos.device, state.qpos.dtype)
    kin = fk(state.qpos)
    M = mass_matrix(kin)
    bias = bias_forces(kin, state.qvel)
    pinch_v, pinch_w = pinch_velocity(kin, state.qvel)

    # contacts
    f_floor, tau_floor, _ = _floor_contact(state)
    f_cube_p, tau_cube_p, f_arm, tau_arm, tau_theta, _ = _pad_contacts(
        state, kin, pinch_v, pinch_w
    )
    if obstacles is not None:
        f_obs, tau_obs, _ = _obstacle_contact(state, obstacles)
        f_floor = f_floor + f_obs
        tau_floor = tau_floor + tau_obs

    # controller torque
    tau_ctrl = opspace_torques(
        kin, M, bias, state.qpos, state.qvel, state.mocap_pos, state.mocap_quat
    )

    # arm contact reaction through the pinch-site spatial Jacobian
    J = point_jacobian(kin, kin.pinch_pos)  # (N, 6, 7) [w; v]
    wrench = torch.cat([tau_arm, f_arm], -1)
    tau_ext = (J.transpose(-1, -2) @ wrench[..., None])[..., 0]

    # arm integration with implicit joint damping
    rhs = tau_ctrl + tau_ext - bias - c["damping"] * state.qvel
    qacc = solve_spd(M + c["damped_diag"], rhs)
    qvel = state.qvel + DT * qacc
    qpos = state.qpos + DT * qvel
    clamped = torch.clamp(qpos, c["lo"], c["hi"])
    qvel = torch.where(clamped == qpos, qvel, torch.zeros_like(qvel))
    qpos = clamped

    # gripper DOF
    theta, dtheta = gr.step_theta(state.theta, state.dtheta, state.grip_ctrl, tau_theta, DT)

    # cube free-body integration
    f_cube = f_floor + f_cube_p + c["cube_weight"]
    tau_cube = tau_floor + tau_cube_p
    linvel = state.cube_linvel + DT * f_cube / CUBE_MASS
    # world-frame rotational dynamics with body-diagonal inertia
    Rc = quat_to_mat(state.cube_quat)
    I_w = Rc @ c["cube_i"] @ Rc.transpose(-1, -2)
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    gyro = cross(state.cube_angvel, mv(I_w, state.cube_angvel))
    angvel = state.cube_angvel + DT * solve3(I_w, tau_cube - gyro)
    cube_pos = state.cube_pos + DT * linvel
    cube_quat = quat_integrate(state.cube_quat, angvel, DT)

    return state._replace(
        qpos=qpos,
        qvel=qvel,
        theta=theta,
        dtheta=dtheta,
        cube_pos=cube_pos,
        cube_quat=cube_quat,
        cube_linvel=linvel,
        cube_angvel=angvel,
    )


def control_step_plain(state: PhysicsState, obstacles=None) -> PhysicsState:
    """10 physics substeps = one 20 ms control period, in plain PyTorch.
    `obstacles`: an optional (M, 2, 3) table of static boxes (see
    `_obstacle_contact`)."""
    if obstacles is not None:
        obstacles = obstacle_table(obstacles, state.qpos.device).to(state.qpos.dtype)
    for _ in range(N_SUBSTEPS):
        state = substep(state, obstacles)
    return state


# ------------------------------------------------------------------ #
# Stepping (CUDA kernel)
# ------------------------------------------------------------------ #

# Layout of the kernel's constant buffer: (name, array), in the order of the
# offsets in csrc/control_step.cuh.
def _kernel_constant_table():
    return (
        ("BODY_POS", BODY_POS), ("BODY_RMAT", BODY_RMAT), ("BODY_MASS", BODY_MASS),
        ("BODY_IPOS", BODY_IPOS), ("BODY_INERTIA", BODY_INERTIA),
        ("ARMATURE", ARMATURE), ("JOINT_DAMPING", JOINT_DAMPING),
        ("JNT_LO", JNT_LO), ("JNT_HI", JNT_HI),
        ("TORQUE_LO", opspace.TORQUE_LO), ("TORQUE_HI", opspace.TORQUE_HI),
        ("Q_HOME", opspace.Q_HOME),
        ("PINCH_POS", PINCH_POS_L7), ("PINCH_RMAT", PINCH_RMAT_L7), ("GRAVITY", GRAVITY),
        ("Y_POLY", gr.Y_POLY), ("Z_POLY", gr.Z_POLY),
        ("DY_POLY", gr.DY_POLY), ("DZ_POLY", gr.DZ_POLY),
        ("PAD_HALF_Y", gr.PAD_HALF_Y), ("PAD_BOX_DZ", gr.PAD_BOX_DZ),
        ("GRIP_INERTIA", gr.INERTIA), ("GRIP_DAMPING", gr.DAMPING),
        ("SPRING_K", gr.SPRING_K), ("SPRING_REF", gr.SPRING_REF),
        ("GRIP_GAIN", gr.GAIN), ("BIAS_KP", gr.BIAS_KP), ("BIAS_KV", gr.BIAS_KV),
        ("F_LO", gr.F_LO), ("F_HI", gr.F_HI),
        ("THETA_LO", gr.THETA_LO), ("THETA_HI", gr.THETA_HI),
        ("CUBE_MASS", CUBE_MASS), ("CUBE_HALF", CUBE_HALF),
        ("CUBE_I_DIAG", CUBE_I_DIAG), ("CORNERS", CORNERS),
        ("KN_FLOOR", KN_FLOOR), ("KD_FLOOR", KD_FLOOR), ("MU_FLOOR", MU_FLOOR),
        ("KN_PAD", KN_PAD), ("KD_PAD", KD_PAD), ("MU_PAD", MU_PAD),
        ("V_EPS", V_EPS), ("IMPULSE_CAP", IMPULSE_CAP), ("LATERAL_LIMIT", LATERAL_LIMIT),
        ("KP_POS", opspace.KP_POS), ("KD_POS", opspace.KD_POS),
        ("KP_ORI", opspace.KP_ORI), ("KD_ORI", opspace.KD_ORI),
        ("KP_NULL", opspace.KP_NULL), ("KD_NULL", opspace.KD_NULL),
        ("DET_THRESHOLD", opspace.DET_THRESHOLD),
        ("EPS_SINGULAR", opspace.EPS_SINGULAR), ("EPS_REGULAR", opspace.EPS_REGULAR),
        ("PIVOT_EPS", PIVOT_EPS), ("DT", DT), ("N_SUBSTEPS", N_SUBSTEPS),
    )


def kernel_constants() -> np.ndarray:
    """The kernel's constant buffer as one flat float32 array."""
    return np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for _, a in _kernel_constant_table()]
    )


@functools.lru_cache(maxsize=None)
def _kernel_constants_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kernel_constants(), device=device)


@functools.lru_cache(maxsize=None)
def _kernel_library():
    """Build (once per source hash) and bind the control-step kernel."""
    from serl_tpu_torch.native.build import load_library

    return bind_library(load_library("control_step"))


def bind_library(lib):
    """Declare the kernel's C entry points on a loaded build of
    csrc/control_step.cu (this module's, or a variant's) and check its
    constant count and obstacle limit."""
    # 22 state fields, the constants, the obstacle table, M, N, the stream
    lib.serl_control_step.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int, ctypes.c_int,
                                                               ctypes.c_void_p]
    lib.serl_control_step.restype = ctypes.c_int
    lib.serl_control_step_constant_count.argtypes = []
    lib.serl_control_step_constant_count.restype = ctypes.c_int
    lib.serl_control_step_max_obstacles.argtypes = []
    lib.serl_control_step_max_obstacles.restype = ctypes.c_int
    lib.serl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.serl_cuda_error_string.restype = ctypes.c_char_p
    want = lib.serl_control_step_constant_count()
    if want != kernel_constants().size:
        raise RuntimeError(
            f"control_step kernel expects {want} constants, the table packs "
            f"{kernel_constants().size}"
        )
    if lib.serl_control_step_max_obstacles() != MAX_OBSTACLES:
        raise RuntimeError(f"control_step kernel takes {lib.serl_control_step_max_obstacles()} "
                           f"obstacles, engine.MAX_OBSTACLES is {MAX_OBSTACLES}")
    return lib


def _check_state(state: PhysicsState) -> int:
    n = state.qpos.shape[0]
    device = state.qpos.device
    for name, width in FIELD_WIDTHS.items():
        x = getattr(state, name)
        shape = (n, width) if width else (n,)
        if x.dtype != torch.float32 or x.device != device or tuple(x.shape) != shape:
            raise ValueError(
                f"PhysicsState.{name}: want float32 {shape} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"PhysicsState.{name} must be contiguous")
    return n


def control_step_cuda(state: PhysicsState, obstacles=None, lib=None) -> PhysicsState:
    """One control step by the CUDA kernel (of `lib`, a `bind_library` of
    another build, where given); the output is a new state. `obstacles`
    (M, 2, 3) is copied to the card unless it lies there as a contiguous
    float32 tensor already."""
    n = _check_state(state)
    device = state.qpos.device
    if device.type != "cuda":
        raise ValueError(f"control_step_cuda needs CUDA tensors, got {device}")
    boxes = None if obstacles is None else obstacle_table(obstacles, device)
    m = 0 if boxes is None else boxes.shape[0]
    lib = lib or _kernel_library()
    out = PhysicsState(*(torch.empty_like(x) for x in state))
    consts = _kernel_constants_on(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.serl_control_step(
            *(x.data_ptr() for x in state), *(x.data_ptr() for x in out),
            consts.data_ptr(), boxes.data_ptr() if m else None, m, n, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"control_step kernel launch failed: {lib.serl_cuda_error_string(rc).decode()}"
        )
    control_step.launches += 1
    return out


def control_step(state: PhysicsState, obstacles=None) -> PhysicsState:
    """One 20 ms control period for every env of `state`, with the cube
    against the static boxes of `obstacles` ((M, 2, 3), shared by every env)
    where given.

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise."""
    if state.qpos.device.type == "cpu":
        return control_step_plain(state, obstacles)
    return control_step_cuda(state, obstacles)


control_step.launches = 0


def observe(state: PhysicsState):
    """(tcp_pos, tcp_vel, cube_pos) like the reference sensors
    (2f85/pinch_pos, 2f85/pinch_vel, block_pos)."""
    kin = fk(state.qpos)
    v, _ = pinch_velocity(kin, state.qvel)
    return kin.pinch_pos, v, state.cube_pos
