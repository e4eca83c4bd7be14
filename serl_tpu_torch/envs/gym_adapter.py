"""Gymnasium adapter and registration for the batched envs.

Port of `serl_tpu/envs/gym_adapter.py`: one env of a batched env behind the
gym API, numpy at the boundary. `PandaPickCubeGymEnv` is the pick task (the
reference's PandaPickCube-v0 / PandaPickCubeVision-v0); `FrankaTaskGymEnv`
exposes the reference robot's `FrankaEnv` surface (observation {"state":
{tcp_pose (xyz + Euler), tcp_vel, gripper_pose, tcp_force, tcp_torque},
"images": {...}}, a 7-dim delta-pose action) over the pose-task env, with
force and torque zeros (the sim has no such sensors; the keys exist so
that actor code written against the robot runs unchanged). Both are
terminated at the time limit and never truncated.

The module is split in two. All of the work sits in gymnasium-free bases,
`PandaPickCubeGymBase` and `FrankaTaskGymBase`: the N = 1 env on an
explicit device ("cuda" unless the caller passes "cpu"), its reset draws
(from the env's own generator, or given: `reset(draws=...)`), the numpy
conversion, `_franka_obs` and `render` (K2 at N = 1). The gym classes, as
in the JAX package defined only where gymnasium imports, add only the
observation and action spaces and `gym.Env`. This is a split inside the
module, not a feature: a machine without gymnasium still runs the bases.

`register_envs()` registers the JAX package's ids (with max_episode_steps
100) for these classes. It is called, not run at import, because the two
packages share the ids: whichever registers last is what `gym.make` builds.
"""

from typing import Dict, Optional

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.envs.rendering import render_cameras
from serl_tpu_torch.envs.tasks import PEG_INSERT_CONFIG, PandaPoseTaskEnv

try:
    import gymnasium as gym
    from gymnasium import spaces

    _HAS_GYM = True
except ImportError:  # pragma: no cover
    _HAS_GYM = False


def _numpy(tree):
    """Env 0 of a batched tree, as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree[0].cpu().numpy()


class _SingleEnv:
    """One env of a batched env: the state, the generator of its resets, the
    action's host-to-device copy and the step's device-to-host copies."""

    def __init__(self, env, seed: int):
        self._env = env
        self.device = env.device
        self._g = torch.Generator(device=self.device).manual_seed(int(seed))
        self._state = None

    def _reset(self, seed: Optional[int], **draws):
        if seed is not None:
            self._g.manual_seed(int(seed))
        self._state, obs = self._env.reset(1, self._g, **draws)
        return obs

    def _step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float32), device=self.device).reshape(1, -1)
        self._state, obs, reward, done, info = self._env.step(self._state, a)
        info = {k: v[0].cpu().numpy() for k, v in info.items()}
        return obs, float(reward[0]), bool(done[0] > 0.5), info


class PandaPickCubeGymBase(_SingleEnv):
    """The single-env pick task without gymnasium: `reset(seed=None,
    options=None, reset_xy=None)` (reset_xy: the cube's (1, 2) position,
    drawn from the env's generator unless given), `step(action)` ->
    (obs, reward, terminated, truncated, info) in numpy, `render()` -> the
    [front, wrist] (size, size, 3) uint8 frames of the current state."""

    def __init__(self, image_obs: bool = False, render_size: int = 128, seed: int = 0,
                 device=None):
        super().__init__(PandaPickCubeEnv(image_obs=image_obs, render_size=render_size,
                                          device=resolve_device(device)), seed)
        self.image_obs = image_obs
        self.render_size = render_size

    def reset(self, *, seed: Optional[int] = None, options=None,
              reset_xy: Optional[torch.Tensor] = None):
        kw = {} if reset_xy is None else {"reset_xy": reset_xy}
        return _numpy(self._reset(seed, **kw)), {}

    def step(self, action):
        obs, reward, done, info = self._step(action)
        return _numpy(obs), reward, done, False, info

    def render(self):
        front, wrist = render_cameras(self._state.physics, self.render_size)
        return [front[0].cpu().numpy(), wrist[0].cpu().numpy()]


class FrankaTaskGymBase(_SingleEnv):
    """The single-env pose task (the peg insert's by default) behind the
    reference `FrankaEnv` surface, without gymnasium: `reset(seed=None,
    options=None, draws=None)` (draws: a `tasks.ResetDraws` of one env,
    drawn from the env's generator unless given), `step(action)`."""

    def __init__(self, config=None, image_obs: bool = False, render_size: int = 128,
                 seed: int = 0, device=None):
        super().__init__(PandaPoseTaskEnv(config or PEG_INSERT_CONFIG, image_obs=image_obs,
                                          render_size=render_size,
                                          device=resolve_device(device)), seed)
        self.image_obs = image_obs

    def _franka_obs(self, obs) -> Dict:
        state = {
            "tcp_pose": obs["state"]["tcp_pose"][0].cpu().numpy().astype(np.float32),
            "tcp_vel": obs["state"]["tcp_vel"][0].cpu().numpy().astype(np.float32),
            "gripper_pose": obs["state"]["gripper_pose"][0].cpu().numpy().astype(np.float32),
            "tcp_force": np.zeros(3, np.float32),
            "tcp_torque": np.zeros(3, np.float32),
        }
        out = {"state": state}
        if self.image_obs:
            out["images"] = {k: v[0].cpu().numpy() for k, v in obs["images"].items()}
        return out

    def reset(self, *, seed: Optional[int] = None, options=None, draws=None):
        kw = {} if draws is None else {"draws": draws}
        return self._franka_obs(self._reset(seed, **kw)), {}

    def step(self, action):
        obs, reward, done, info = self._step(action)
        return self._franka_obs(obs), reward, done, False, info


ENV_IDS = {
    "PandaPickCube-v0": ("PandaPickCubeGymEnv", {"image_obs": False}),
    "PandaPickCubeVision-v0": ("PandaPickCubeGymEnv", {"image_obs": True}),
    "FrankaPegInsert-v0": ("FrankaTaskGymEnv", {"image_obs": False}),
    "FrankaPegInsert-Vision-v0": ("FrankaTaskGymEnv", {"image_obs": True}),
}


if _HAS_GYM:

    def _image_spaces(render_size: int):
        return spaces.Dict({k: spaces.Box(0, 255, (render_size, render_size, 3), np.uint8)
                            for k in ("front", "wrist")})

    class PandaPickCubeGymEnv(PandaPickCubeGymBase, gym.Env):
        """The single-env pick task as a gym.Env."""

        metadata = {"render_modes": ["rgb_array"], "render_fps": 50}

        def __init__(self, image_obs: bool = False, render_size: int = 128, seed: int = 0,
                     device=None):
            PandaPickCubeGymBase.__init__(self, image_obs, render_size, seed, device)
            box = lambda n: spaces.Box(-np.inf, np.inf, (n,), np.float32)
            state = {"panda/tcp_pos": box(3), "panda/tcp_vel": box(3),
                     "panda/gripper_pos": box(1)}
            if image_obs:
                self.observation_space = spaces.Dict({"state": spaces.Dict(state),
                                                      "images": _image_spaces(render_size)})
            else:
                state["block_pos"] = box(3)
                self.observation_space = spaces.Dict({"state": spaces.Dict(state)})
            self.action_space = spaces.Box(-1.0, 1.0, (4,), np.float32)

    class FrankaTaskGymEnv(FrankaTaskGymBase, gym.Env):
        """The reference FrankaEnv surface over the pose-task env, as a gym.Env."""

        metadata = {"render_modes": ["rgb_array"], "render_fps": 10}

        def __init__(self, config=None, image_obs: bool = False, render_size: int = 128,
                     seed: int = 0, device=None):
            FrankaTaskGymBase.__init__(self, config, image_obs, render_size, seed, device)
            box = lambda n: spaces.Box(-np.inf, np.inf, (n,), np.float32)
            d = {"state": spaces.Dict({"tcp_pose": box(6), "tcp_vel": box(3),
                                       "gripper_pose": box(1), "tcp_force": box(3),
                                       "tcp_torque": box(3)})}
            if image_obs:
                d["images"] = _image_spaces(render_size)
            self.observation_space = spaces.Dict(d)
            self.action_space = spaces.Box(-1.0, 1.0, (7,), np.float32)

    def register_envs(**kwargs):
        """Register ENV_IDS for this module's classes (max_episode_steps
        100), each with `kwargs` (e.g. device="cpu") added to its own."""
        for env_id, (cls, own) in ENV_IDS.items():
            gym.register(id=env_id, entry_point=f"{__name__}:{cls}", max_episode_steps=100,
                         kwargs={**own, **kwargs})
