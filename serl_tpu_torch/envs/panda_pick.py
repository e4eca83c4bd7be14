"""Batched PandaPickCube environment (the reference benchmark task).

Port of `serl_tpu/envs/panda_pick.py`, with the same action semantics
(dx, dy, dz, grasp scaled by (0.1, 1), mocap target clipped to the cartesian
bounds), 20 ms control / 2 ms physics split, observation dict, reward
0.3*exp(-20 dist) + 0.7*lift-progress and 100-step episodes.

Where the JAX env is a single-env function that the loop vmaps, this env
steps all N envs of a structure-of-arrays `EnvState` at once. JAX keeps a
per-env PRNG key in the state for auto-reset; here the reset cube positions
come from the `torch.Generator` the caller passes, or are given explicitly
as `reset_xy` (the tests feed the JAX draws that way). With `image_obs=True`
the observation carries the front and wrist camera frames (K2,
`envs/rendering.py`) and its state part drops `block_pos`, as in the JAX
package.

JAX's `step_auto_reset` always returns the pre-reset observation in
info["final_obs"] and leaves XLA to drop its render when the caller never
reads it; eager PyTorch would really render twice. So the caller says
whether it needs it (`final_obs=`), and the pixel loop, whose buffer
rebuilds next observations from the ring, asks only for the one render of
the post-reset state.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.distributed.sharding import local, num_ranks
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.rendering import render_cameras
from serl_tpu_torch.utils.timer import span

# reference constants (panda_pick_gym_env.py:21-23)
CARTESIAN_BOUNDS = np.asarray([[0.2, -0.3, 0.0], [0.6, 0.3, 0.5]], np.float32)
SAMPLING_BOUNDS = np.asarray([[0.25, -0.25], [0.55, 0.25]], np.float32)
ACTION_SCALE = np.asarray([0.1, 1.0], np.float32)
TIME_LIMIT_STEPS = 100  # 10 s / 0.02 s
ACTION_DIM = 4
STATE_OBS_DIM = 10  # tcp_pos(3) + tcp_vel(3) + gripper(1) + block_pos(3)
PIXEL_STATE_DIM = 7  # with images: tcp_pos(3) + tcp_vel(3) + gripper(1)


class EnvState(NamedTuple):
    physics: engine.PhysicsState
    t: torch.Tensor  # (N,) int32 control steps taken
    z_init: torch.Tensor  # (N,) initial block height
    ep_id: torch.Tensor  # (N,) int32 monotonically increasing episode counter


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env select: b where mask, else a (mask has shape (N,))."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), b, a)


def where_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Every field of env state b where the (N,) mask is set, else a's."""
    return EnvState(
        physics=engine.PhysicsState(*(_where(mask, x, y) for x, y in zip(a.physics, b.physics))),
        t=_where(mask, a.t, b.t),
        z_init=_where(mask, a.z_init, b.z_init),
        ep_id=_where(mask, a.ep_id, b.ep_id),
    )


class PandaPickCubeEnv:
    """Batched env: every method steps all envs of the state at once."""

    def __init__(self, image_obs: bool = False, render_size: int = 128, device=None):
        self.image_obs = bool(image_obs)
        self.render_size = int(render_size)
        self.device = resolve_device(device)
        self._bounds = torch.as_tensor(CARTESIAN_BOUNDS, device=self.device)
        self._sampling = torch.as_tensor(SAMPLING_BOUNDS, device=self.device)

    @property
    def time_limit_steps(self) -> int:
        """Episode length, read by `training.loop.evaluate`."""
        return TIME_LIMIT_STEPS

    # ------------------------------------------------------------------ #

    def sample_reset_xy(self, num_envs: int, generator: Optional[torch.Generator] = None):
        """(num_envs, 2) cube positions, uniform over SAMPLING_BOUNDS."""
        u = torch.rand((num_envs, 2), generator=generator, device=self.device)
        lo, hi = self._sampling[0], self._sampling[1]
        return lo + (hi - lo) * u

    def _fresh(self, xy: torch.Tensor, ep_id: torch.Tensor) -> EnvState:
        phys = engine.init_state(xy)
        return EnvState(
            physics=phys,
            t=torch.zeros_like(ep_id),
            z_init=phys.cube_pos[:, 2].clone(),
            ep_id=ep_id,
        )

    def reset(
        self,
        num_envs: int,
        generator: Optional[torch.Generator] = None,
        reset_xy: Optional[torch.Tensor] = None,
    ) -> Tuple[EnvState, Dict]:
        if reset_xy is None:
            reset_xy = self.sample_reset_xy(num_envs, generator)
        ep_id = torch.zeros((num_envs,), dtype=torch.int32, device=self.device)
        state = self._fresh(reset_xy.to(self.device, torch.float32), ep_id)
        return state, self._obs(state)

    def _step_state(self, state: EnvState, action: torch.Tensor):
        """Physics + reward only (no observation): (state, reward, done, info)."""
        action = torch.clamp(action, -1.0, 1.0)
        dpos = action[:, :3] * float(ACTION_SCALE[0])
        npos = torch.clamp(state.physics.mocap_pos + dpos, self._bounds[0], self._bounds[1])
        g = state.physics.grip_ctrl / 255.0
        ng = torch.clamp(g + action[:, 3] * float(ACTION_SCALE[1]), 0.0, 1.0)
        phys = state.physics._replace(mocap_pos=npos, grip_ctrl=ng * 255.0)

        phys = engine.control_step(phys)
        new_state = state._replace(physics=phys, t=state.t + 1)

        reward = self._reward(new_state)
        done = (new_state.t >= TIME_LIMIT_STEPS).to(torch.float32)
        info = {"success": self._success(new_state)}
        return new_state, reward, done, info

    def step(self, state: EnvState, action: torch.Tensor):
        """Returns (state, obs, reward, done, info); `done` mirrors the
        reference's `terminated = time_limit_exceeded()`."""
        new_state, reward, done, info = self._step_state(state, action)
        return new_state, self._obs(new_state), reward, done, info

    def step_auto_reset(
        self,
        state: EnvState,
        action: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        reset_xy: Optional[torch.Tensor] = None,
        final_obs: bool = True,
        dp=None,
    ):
        """Step; where an episode ends, swap in a freshly reset env.

        Returns (state, obs, reward, done, info) where `obs` is the reset
        observation for ended envs (gym vector-env autoreset) and, when
        `final_obs`, info["final_obs"] the pre-reset terminal observation
        (with images, a second render). Every state field is swapped and the
        ep_id of a reset env is the old one + 1. Reset positions are drawn
        for all envs every step from `generator` (no host sync on `done`),
        unless `reset_xy` gives them. Under data parallelism (`dp`, a
        `distributed.sharding.DataParallel`) `state` holds the rank's envs:
        the positions are drawn for every rank's envs, as one rank would
        draw them for all, and the rank keeps its own."""
        with span("env.step"):
            stepped, reward, done, info = self._step_state(state, action)
            n = action.shape[0]
            if reset_xy is None:
                reset_xy = local(self.sample_reset_xy(n * num_ranks(dp), generator), dp)
            fresh = self._fresh(reset_xy.to(self.device, torch.float32), state.ep_id + 1)
            new_state = where_state(done > 0.5, stepped, fresh)
            out_obs = self._obs(new_state)
            info = dict(info)
            if final_obs:
                info["final_obs"] = self._obs(stepped)
            return new_state, out_obs, reward, done, info

    # ------------------------------------------------------------------ #

    def _obs(self, state: EnvState) -> Dict:
        tcp_pos, tcp_vel, block_pos = engine.observe(state.physics)
        obs_state = {
            "panda/tcp_pos": tcp_pos,
            "panda/tcp_vel": tcp_vel,
            "panda/gripper_pos": (state.physics.grip_ctrl / 255.0)[:, None],
        }
        if self.image_obs:
            front, wrist = render_cameras(state.physics, self.render_size)
            return {"state": obs_state, "images": {"front": front, "wrist": wrist}}
        obs_state["block_pos"] = block_pos
        return {"state": obs_state}

    def _reward(self, state: EnvState) -> torch.Tensor:
        """0.3 * exp(-20 dist(tcp, block)) + 0.7 * lift progress."""
        tcp_pos, _, block_pos = engine.observe(state.physics)
        d = block_pos - tcp_pos
        dist = torch.sqrt((d * d).sum(-1))
        r_close = torch.exp(-20.0 * dist)
        z_success = state.z_init + 0.2
        r_lift = (block_pos[:, 2] - state.z_init) / (z_success - state.z_init)
        r_lift = torch.clamp(r_lift, 0.0, 1.0)
        return 0.3 * r_close + 0.7 * r_lift

    def _success(self, state: EnvState) -> torch.Tensor:
        return (state.physics.cube_pos[:, 2] >= state.z_init + 0.2).to(torch.float32)


def flatten_obs(obs: Dict) -> torch.Tensor:
    """Dict state obs -> flat vector in SORTED key order (like gym
    FlattenObservation): block_pos, panda/gripper_pos, panda/tcp_pos,
    panda/tcp_vel."""
    parts = [obs["state"][k] for k in sorted(obs["state"].keys())]
    return torch.cat(parts, dim=-1)
