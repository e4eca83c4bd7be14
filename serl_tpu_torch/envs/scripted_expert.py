"""Scripted expert policy for PandaPickCube.

Port of `serl_tpu/envs/scripted_expert.py::expert_action`, batched over the
N envs of a structure-of-arrays `EnvState`: a stateless geometric state
machine (approach above the block, descend, close, lift) computed from the
physics state each step. It generates the RLPD demos and is the default
expert of the loop's interventions. (`pose_expert_action` and
`relocation_expert_action`, the task envs' experts, are not ported yet.)
"""

from typing import Optional

import torch

from serl_tpu_torch.envs.panda_pick import EnvState
from serl_tpu_torch.envs.physics import engine


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
