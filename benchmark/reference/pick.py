"""The plain reference of the pick-cube env's step: the port's plain physics and
renderer (frozen copies in `env/`), with the env's action scaling, reward,
time limit and auto-reset written out again from `serl_tpu_torch/envs/panda_pick.py`.

A state is a dict of the program's `EnvState` fields: the physics fields
(`env.engine.PhysicsState`), "t", "z_init" and "ep_id". Every function takes
the dtype it computes in, so that the check can read float32's distance to
float64 (the K1 rule's spread) and the control can run a step below float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.env import engine, rendering

CARTESIAN_BOUNDS = ((0.2, -0.3, 0.0), (0.6, 0.3, 0.5))
ACTION_SCALE = (0.1, 1.0)
TIME_LIMIT_STEPS = 100
PHYSICS = engine.PhysicsState._fields


def physics(state: Dict, dtype) -> engine.PhysicsState:
    """The physics fields in `dtype`; below float32 they are rounded to it
    and held in float32, in which the plain physics computes."""
    if dtype in (torch.float32, torch.float64):
        return engine.PhysicsState(*(state[f].to(dtype) for f in PHYSICS))
    return engine.PhysicsState(*(state[f].to(dtype).to(torch.float32) for f in PHYSICS))


def _held(dtype):
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def fresh(xy: torch.Tensor, ep_id: torch.Tensor, dtype) -> Dict:
    """A reset env at cube positions `xy`."""
    phys = physics(engine.init_state(xy.to(_held(dtype)))._asdict(), dtype)
    return {**phys._asdict(), "t": torch.zeros_like(ep_id), "z_init": phys.cube_pos[:, 2].clone(),
            "ep_id": ep_id}


def _reward(phys: engine.PhysicsState, z_init: torch.Tensor) -> torch.Tensor:
    tcp_pos, _, block_pos = engine.observe(phys)
    d = block_pos - tcp_pos
    r_close = torch.exp(-20.0 * torch.sqrt((d * d).sum(-1)))
    r_lift = torch.clamp((block_pos[:, 2] - z_init) / 0.2, 0.0, 1.0)
    return 0.3 * r_close + 0.7 * r_lift


def step(state: Dict, action: torch.Tensor, reset_xy: torch.Tensor, dtype) -> Tuple[Dict, Dict, Dict]:
    """One `step_auto_reset`: (the state before any reset, the state after
    it, {"reward", "done", "success"})."""
    phys = physics(state, dtype)
    held = _held(dtype)
    action = torch.clamp(action.to(dtype).to(held), -1.0, 1.0)
    lo = torch.tensor(CARTESIAN_BOUNDS[0], dtype=held, device=action.device)
    hi = torch.tensor(CARTESIAN_BOUNDS[1], dtype=held, device=action.device)
    npos = torch.clamp(phys.mocap_pos + action[:, :3] * ACTION_SCALE[0], lo, hi)
    ng = torch.clamp(phys.grip_ctrl / 255.0 + action[:, 3] * ACTION_SCALE[1], 0.0, 1.0)
    phys = engine.control_step_plain(phys._replace(mocap_pos=npos, grip_ctrl=ng * 255.0))
    phys = physics(phys._asdict(), dtype)
    z_init = state["z_init"].to(held)
    stepped = {**phys._asdict(), "t": state["t"] + 1, "z_init": z_init, "ep_id": state["ep_id"]}
    done = stepped["t"] >= TIME_LIMIT_STEPS
    out = {"reward": _reward(phys, z_init), "done": done.to(dtype),
           "success": (phys.cube_pos[:, 2] >= z_init + 0.2).to(dtype)}
    new = fresh(reset_xy, state["ep_id"] + 1, dtype)
    after = {k: torch.where(done.view((-1,) + (1,) * (v.dim() - 1)), new[k], v)
             for k, v in stepped.items()}
    return stepped, after, out


def observe(state: Dict, size: int, dtype) -> Dict[str, torch.Tensor]:
    """The pixel observation of a state: the flat proprio state (gripper,
    tcp_pos, tcp_vel: the sorted key order) and both cameras' frames. Below
    float32 the scene is built in float32 and its rays are traced in `dtype`."""
    phys = physics(state, dtype)
    tcp_pos, tcp_vel, _ = engine.observe(phys)
    if dtype in (torch.float32, torch.float64):
        front, wrist = rendering.render_cameras_plain(phys, size)
    else:
        f32 = physics(state, torch.float32)
        scene = rendering.Scene(*(x.to(dtype) for x in rendering.build_scene(f32)))
        pos, rot = (x.to(dtype) for x in rendering.camera_poses(f32))
        grid = rendering.pixel_grid(size, f32.qpos.device).to(dtype)
        front, wrist = (rendering.render_scene_plain(scene, pos[:, c], rot[:, c], grid[c], size)
                        for c in (0, 1))
    return {"state": torch.cat([(phys.grip_ctrl / 255.0)[:, None], tcp_pos, tcp_vel], -1),
            "front": front, "wrist": wrist}
