"""Observation wrappers for batched envs.

Port of `serl_obs` and `add_stack_axis` from `serl_tpu/envs/wrappers.py`:
pure functions over observation dicts. (`chunk_init`/`chunk_push`, the
loop's frame-stack history, and `act_exec_step` are not ported yet.)
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
