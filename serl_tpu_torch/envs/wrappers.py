"""Observation wrappers for batched envs.

Port of `serl_obs`, `add_stack_axis`, `quat_to_euler` and `euler_to_quat`
from `serl_tpu/envs/wrappers.py`: pure functions over observation dicts and
batched quaternions. (`chunk_init`/`chunk_push`, the loop's frame-stack
history, `act_exec_step`, `adjoint_matrix` and `pose_relative_to` are not
ported yet.)
"""

from typing import Dict, Tuple

import torch


def serl_obs(obs: Dict) -> Dict:
    """Env obs {"state": {...}, "images": {...}} -> the SERL flat convention
    {"state": concat(state values in sorted key order), "<image_key>": img}."""
    state = obs["state"]
    out = {"state": torch.cat([state[k] for k in sorted(state)], dim=-1)}
    for k, v in obs.get("images", {}).items():
        out[k] = v
    return out


def add_stack_axis(obs: Dict, image_keys: Tuple[str, ...]) -> Dict:
    """Give live (unstacked) images the explicit T = 1 frame-stack axis the
    agents expect: (..., H, W, C) -> (..., 1, H, W, C)."""
    out = dict(obs)
    for k in image_keys:
        img = out[k]
        out[k] = img.unsqueeze(img.dim() - 3)
    return out


def quat_to_euler(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3) roll, pitch, yaw (scipy's "xyz").
    At the pose tasks' roll of pi, atan2 flips between +pi and -pi with the
    sign of a rounding-sized term: compare rolls modulo 2 pi."""
    w, x, y, z = quat.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """(..., 3) roll, pitch, yaw -> (..., 4) (w, x, y, z)."""
    roll, pitch, yaw = euler.unbind(-1)
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )
