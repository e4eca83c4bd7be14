"""Scripted expert policy for PandaPickCube.

Port of `serl_tpu/envs/scripted_expert.py::expert_action`, batched over the
N envs of a structure-of-arrays `EnvState`: a stateless geometric state
machine (approach above the block, descend, close, lift) computed from the
physics state each step. It generates the RLPD demos and is the default
expert of the loop's interventions. `pose_expert_action` is the pose
tasks' expert (peg and PCB insertion); `relocation_expert_action`, the bin
task's, is not ported yet.
"""

from typing import Optional, Sequence, Union

import torch

from serl_tpu_torch.envs.panda_pick import EnvState
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.physics.arm import fk, pinch_velocity
from serl_tpu_torch.envs.physics.math3d import mat_to_quat, quat_conj, quat_mul, quat_to_axis_angle
from serl_tpu_torch.envs.wrappers import euler_to_quat


def expert_action(state: EnvState, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 4) actions for the N envs of `state`. `noise`, (N, 4) or (4,)
    (one vector for every env), is added before the final clip to [-1, 1]."""
    phys = state.physics
    tcp, _, block = engine.observe(phys)
    xy_err = torch.linalg.vector_norm(tcp[:, :2] - block[:, :2], dim=-1)
    lifted = block[:, 2] > 0.06
    closing = phys.theta > 0.25
    aligned = xy_err < 0.010
    near_grasp = aligned & (tcp[:, 2] < block[:, 2] + 0.012)

    # targets per phase
    xy = block[:, :2]
    above = torch.cat([xy, torch.full_like(block[:, 2:3], 0.18)], -1)
    down = torch.cat([xy, block[:, 2:3] - 0.006], -1)
    lift = torch.cat([xy, torch.full_like(block[:, 2:3], 0.35)], -1)
    target = torch.where((closing | lifted)[:, None], lift,
                         torch.where(aligned[:, None], down, above))
    grasp = torch.where(near_grasp | closing | lifted, 1.0, -1.0)

    delta = torch.clamp((target - phys.mocap_pos) / 0.1, -1.0, 1.0)
    action = torch.cat([delta, grasp[:, None]], -1)
    if noise is not None:
        action = action + noise
    return torch.clamp(action, -1.0, 1.0)


def pose_expert_action(state: EnvState, target_pose: Union[Sequence[float], torch.Tensor],
                       action_scale: Union[Sequence[float], torch.Tensor],
                       noise: Optional[torch.Tensor] = None,
                       approach_z: float = 0.15) -> torch.Tensor:
    """(N, 7) actions for `envs/tasks.py::PandaPoseTaskEnv`: align xy above
    the target, then descend to the target pose, turning toward the
    target's orientation; the gripper stays. It acts on what the policy
    observes (the measured pinch pose from FK and its velocity), not the
    hidden mocap target, with tcp_vel damping against the tracking lag.
    `noise`, (N, 7) or (7,), is added before the final clip to [-1, 1]."""
    phys = state.physics
    device = phys.qpos.device
    target_pose = torch.as_tensor(target_pose, dtype=torch.float32, device=device)
    action_scale = torch.as_tensor(action_scale, dtype=torch.float32, device=device)
    kin = fk(phys.qpos)
    tcp = kin.pinch_pos
    tcp_vel, _ = pinch_velocity(kin, phys.qvel)
    target = target_pose[:3]
    xy_err = torch.linalg.vector_norm(tcp[:, :2] - target[:2], dim=-1)
    aligned = xy_err < 0.005
    goal_z = torch.where(aligned, target[2], torch.clamp(tcp[:, 2], min=approach_z))
    goal = torch.cat([target[:2].expand(tcp.shape[0], 2), goal_z[:, None]], -1)
    dpos = torch.clamp((goal - tcp) / (action_scale[0] * 2.0) - 1.0 * tcp_vel, -1.0, 1.0)
    # the env turns by action[3:6] as a world-frame axis-angle rotation, so
    # the error is the log of target * conj(measured orientation)
    q_rel = quat_mul(euler_to_quat(target_pose[3:6]), quat_conj(mat_to_quat(kin.pinch_rmat)))
    drot = torch.clamp(quat_to_axis_angle(q_rel) / torch.clamp(action_scale[1], min=1e-6),
                       -1.0, 1.0)
    action = torch.cat([dpos, drot, torch.zeros_like(dpos[:, :1])], -1)
    if noise is not None:
        action = action + noise
    return torch.clamp(action, -1.0, 1.0)
