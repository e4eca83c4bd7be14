"""Config-driven pose tasks over the batched engine: peg and PCB insertion.

Port of `serl_tpu/envs/tasks.py`: `PoseTaskConfig` and the PEG, PCB and
CABLE configs value for value, and `PandaPoseTaskEnv`, batched over the N
envs of a structure-of-arrays `EnvState` like the port's pick env. Actions
are 7-dim (dx dy dz droll dpitch dyaw grasp): the position target moves in
its cartesian box, the orientation target turns by the world-frame
axis-angle rotation, then its Euler angles are unwrapped toward the safety
box's centre and clipped into it. The reward is sparse (every pose dim
within its threshold of TARGET_POSE, angles wrapped), less the gripper
penalty, and an episode ends early on success.

A reset is the pick env's (cube uniform over its sampling box) with the
mocap moved to the reset pose, its xy and yaw jittered, then 5 control
steps (K1) to let the controller settle, then, with a demo reset bank,
possibly a bank state's physics. Like the JAX package, `step_auto_reset`
computes that fresh reset for every env every step and selects per env
(6 K1 launches an env step), so nothing waits for `done` on the host. The
JAX env keeps a key per env for its resets; here the draws come from the
caller's `torch.Generator`, or are given as `ResetDraws` (the tests feed
JAX's that way).

Observations: "tcp_pose" (pinch position and Euler angles from FK),
"tcp_vel", "gripper_pose" and "block_pos" (13 flat); with `image_obs` both
cameras' frames (K2) and no "block_pos" (10-dim proprio). The roll of
"tcp_pose" sits at the +pi/-pi flip of `quat_to_euler` for the whole task:
it is the JAX package's observation, kept as it is.

`BinRelocationEnv` is the forward/backward bin relocation task: two bins
with physical walls (an (8, 2, 3) table of static boxes that K1 takes as
its obstacle input in every control step), the cube placed in the source
bin at every reset (the `_place_objects` hook: after the settle steps, before
the demo-reset draw, with its own jitter draw), success = the cube inside
the target bin and below 5 cm, and either the sparse reward or, with
`dense_shaping`, reach, lift and carry terms. On a pose task
`dense_shaping = True` only turns off the early termination on success, as
in the JAX package.
"""

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from serl_tpu_torch.distributed.sharding import local, num_ranks
from serl_tpu_torch.envs.panda_pick import EnvState, PandaPickCubeEnv, where_state
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.physics.arm import fk, pinch_velocity
from serl_tpu_torch.envs.physics.math3d import mat_to_quat, norm, quat_from_axis_angle, quat_mul
from serl_tpu_torch.envs.rendering import render_cameras
from serl_tpu_torch.envs.wrappers import euler_to_quat, quat_to_euler

STATE_OBS_DIM = 13  # tcp_pose(6) + tcp_vel(3) + gripper(1) + block_pos(3)
PIXEL_STATE_DIM = 10  # with images: tcp_pose(6) + tcp_vel(3) + gripper(1)
SETTLE_STEPS = 5  # control steps at the reset pose before an episode starts


class PoseTaskConfig(NamedTuple):
    """The JAX package's PoseTaskConfig (reference DefaultEnvConfig)."""

    target_pose: Tuple[float, ...] = (0.4, 0.0, 0.06, 3.14159, 0.0, 0.0)
    reset_pose: Tuple[float, ...] = (0.4, 0.0, 0.25, 3.14159, 0.0, 0.0)
    reward_threshold: Tuple[float, ...] = (0.01, 0.01, 0.01, 0.2, 0.2, 0.2)
    action_scale: Tuple[float, float, float] = (0.02, 0.1, 1.0)  # pos, rot, grip
    random_xy_range: float = 0.05
    random_rz_range: float = 0.0
    enable_rotation: bool = True
    gripper_penalty: float = 0.0
    time_limit_steps: int = 100
    cartesian_lo: Tuple[float, float, float] = (0.2, -0.3, 0.0)
    cartesian_hi: Tuple[float, float, float] = (0.6, 0.3, 0.5)
    # the Euler-angle safety box; (-3.2, 3.2) on every axis leaves it unconstrained
    rot_lo: Tuple[float, float, float] = (-3.2, -3.2, -3.2)
    rot_hi: Tuple[float, float, float] = (3.2, 3.2, 3.2)


_PI = 3.14159265
# peg_env/config.py: reset 10 cm above the target, thresholds 1 cm / 0.2 rad,
# a box of +-5 cm in xy around the target, roll and pitch pinned to +-0.01
PEG_INSERT_CONFIG = PoseTaskConfig(
    target_pose=(0.40, 0.10, 0.045, _PI, 0.0, 0.0),
    reset_pose=(0.40, 0.10, 0.145, _PI, 0.0, 0.0),
    reward_threshold=(0.01, 0.01, 0.01, 0.2, 0.2, 0.2),
    action_scale=(0.02, 0.1, 1.0),
    random_xy_range=0.05,
    random_rz_range=_PI / 6,
    gripper_penalty=0.0,
    cartesian_lo=(0.35, 0.05, 0.045),
    cartesian_hi=(0.45, 0.15, 0.145),
    rot_lo=(_PI - 0.01, -0.01, -_PI / 6),
    rot_hi=(_PI + 0.01, 0.01, _PI / 6),
)
# pcb_env/config.py: reset 4 cm above the target, thresholds 5/5/3 mm and
# 0.1 rad, roll and pitch within +-0.05, yaw +-pi/9
PCB_INSERT_CONFIG = PoseTaskConfig(
    target_pose=(0.45, -0.05, 0.035, _PI, 0.0, 0.0),
    reset_pose=(0.45, -0.05, 0.075, _PI, 0.0, 0.0),
    reward_threshold=(0.005, 0.005, 0.003, 0.1, 0.1, 0.1),
    action_scale=(0.02, 0.2, 1.0),
    random_xy_range=0.05,
    random_rz_range=_PI / 9,
    cartesian_lo=(0.40, -0.10, 0.030),
    cartesian_hi=(0.50, 0.00, 0.085),
    rot_lo=(_PI - 0.05, -0.05, -_PI / 9),
    rot_hi=(_PI + 0.05, 0.05, _PI / 9),
)
# cable_env/config.py: a pose threshold stands in for the learned classifier
CABLE_ROUTE_CONFIG = PoseTaskConfig(
    target_pose=(0.38, 0.15, 0.08, _PI, 0.0, 0.3),
    reset_pose=(0.38, 0.10, 0.18, _PI, 0.0, 0.0),
    reward_threshold=(0.02, 0.02, 0.02, 0.2, 0.2, 0.2),
    action_scale=(0.05, 0.3, 1.0),
    random_xy_range=0.05,
    random_rz_range=0.2,
    cartesian_lo=(0.28, 0.05, 0.079),
    cartesian_hi=(0.48, 0.25, 0.28),
    rot_lo=(_PI - 0.01, -0.01, -_PI / 6),
    rot_hi=(_PI + 0.01, 0.01, _PI / 6),
)


class ResetDraws(NamedTuple):
    """The random numbers of one reset of N envs."""

    xy: torch.Tensor  # (N, 2) cube position, uniform over the pick env's sampling box
    dxy: torch.Tensor  # (N, 2) reset-pose xy offset, uniform in +-random_xy_range
    drz: torch.Tensor  # (N,) reset-pose yaw offset, uniform in +-random_rz_range
    use: Optional[torch.Tensor] = None  # (N,) uniform: a bank state where < demo_reset_prob
    idx: Optional[torch.Tensor] = None  # (N,) int64 bank row
    jitter: Optional[torch.Tensor] = None  # (N, 2) the bin task's cube offset in its source bin


class PandaPoseTaskEnv:
    """Sparse pose-reaching task over the pick env's physics (the cube is
    scene clutter here). Every method steps all envs of the state at once."""

    ACTION_DIM = 7

    def __init__(self, config: PoseTaskConfig = PoseTaskConfig(), image_obs: bool = False,
                 render_size: int = 128, device=None):
        self.config = config
        self.image_obs = bool(image_obs)
        self.render_size = int(render_size)
        self._base = PandaPickCubeEnv(device=device)
        self.device = self._base.device
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self._reset_pose = t(config.reset_pose)
        self._target = t(config.target_pose)
        self._threshold = t(config.reward_threshold)
        self._cartesian = (t(config.cartesian_lo), t(config.cartesian_hi))
        rot_lo, rot_hi = t(config.rot_lo), t(config.rot_hi)
        self._rot_box = (rot_lo, rot_hi, 0.5 * (rot_lo + rot_hi))
        # the box constrains an angle only inside (-3.15, 3.15) (a static check)
        self._clip_rot = max(config.rot_lo) > -3.15 or min(config.rot_hi) < 3.15
        # an optional reverse-curriculum bank: with probability
        # `_demo_reset_prob` an episode starts from a random bank state
        self._demo_bank: Optional[EnvState] = None
        self._demo_reset_prob = 0.0
        # True: success no longer ends an episode (the reward stays the
        # sparse one here; vice_online sets it to run whole episodes)
        self.dense_shaping = False
        # an optional (M, 2, 3) table of static boxes the cube collides with
        # (BinRelocationEnv's walls); None = the free tabletop
        self.obstacles: Optional[torch.Tensor] = None

    def set_demo_reset_bank(self, bank: EnvState, prob: float) -> None:
        """`bank`: an EnvState whose leading axis is the bank's (M, ...)
        (`data/demos.py::collect_state_bank`); `prob`: the per-episode
        probability of starting from one of its states."""
        to = lambda x: x.to(self.device)
        self._demo_bank = EnvState(engine.PhysicsState(*map(to, bank.physics)), to(bank.t),
                                   to(bank.z_init), to(bank.ep_id))
        self._demo_reset_prob = float(prob)

    @property
    def time_limit_steps(self) -> int:
        """Episode length from the task config (read by `training.loop.evaluate`)."""
        return self.config.time_limit_steps

    # ------------------------------------------------------------------ #

    def _bank_in_use(self) -> bool:
        return self._demo_bank is not None and self._demo_reset_prob > 0.0

    def sample_reset_draws(self, num_envs: int,
                           generator: Optional[torch.Generator] = None) -> ResetDraws:
        """One reset's draws for `num_envs` envs from `generator`."""
        cfg = self.config
        u = lambda *shape: torch.rand(shape, generator=generator, device=self.device)
        xy = self._base.sample_reset_xy(num_envs, generator)
        dxy = (2.0 * u(num_envs, 2) - 1.0) * cfg.random_xy_range
        drz = (2.0 * u(num_envs) - 1.0) * cfg.random_rz_range
        if not self._bank_in_use():
            return ResetDraws(xy, dxy, drz)
        m = self._demo_bank.t.shape[0]
        idx = torch.randint(0, m, (num_envs,), generator=generator, device=self.device)
        return ResetDraws(xy, dxy, drz, u(num_envs), idx)

    def _reset_state(self, draws: ResetDraws, pose: Optional[torch.Tensor] = None,
                     source: Optional[torch.Tensor] = None) -> EnvState:
        """A reset at the task's reset pose, or at `pose` ((6,) or (N, 6)
        xyz + Euler); `source` goes to `_place_objects` (ChainedBinEnv
        passes each env's own task's pose and bin)."""
        n = draws.xy.shape[0]
        f32 = lambda x: x.to(self.device, torch.float32)
        state = self._base._fresh(f32(draws.xy), torch.zeros((n,), dtype=torch.int32,
                                                             device=self.device))
        pose = self._reset_pose if pose is None else pose
        pos = torch.cat([pose[..., :2] + f32(draws.dxy), pose[..., 2:3].expand(n, 1)], -1)
        euler = torch.cat([pose[..., 3:5].expand(n, 2), (pose[..., 5] + f32(draws.drz))[:, None]],
                          -1)
        phys = state.physics._replace(mocap_pos=pos, mocap_quat=euler_to_quat(euler))
        for _ in range(SETTLE_STEPS):  # let the controller settle at the reset pose
            phys = engine.control_step(phys, self.obstacles)
        # the task's objects are placed after the settle, before the demo-reset draw
        state = self._place_objects(state._replace(physics=phys), draws, source)
        return self._maybe_demo_reset(state, draws)

    def _place_objects(self, state: EnvState, draws: ResetDraws,
                       source: Optional[torch.Tensor] = None) -> EnvState:
        """Task-specific object placement at reset; the pose tasks keep the
        pick env's uniform cube placement."""
        return state

    def _maybe_demo_reset(self, state: EnvState, draws: ResetDraws) -> EnvState:
        """Where draws.use < the bank probability, a bank state's physics and
        z_init (the episode clock and ep_id stay the fresh ones)."""
        if not self._bank_in_use():
            return state
        bank, idx = self._demo_bank, draws.idx.to(self.device)
        demo = state._replace(physics=engine.PhysicsState(*(x[idx] for x in bank.physics)),
                              z_init=bank.z_init[idx])
        return where_state(draws.use.to(self.device) < self._demo_reset_prob, state, demo)

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              draws: Optional[ResetDraws] = None) -> Tuple[EnvState, Dict]:
        if draws is None:
            draws = self.sample_reset_draws(num_envs, generator)
        state = self._reset_state(draws)
        return state, self._obs(state)

    def _apply_action(self, state: EnvState, action: torch.Tensor):
        """The action on the mocap target and grip command, then one control
        step; returns (state, gripper_moved)."""
        cfg = self.config
        action = torch.clamp(action, -1.0, 1.0)
        phys = state.physics
        npos = torch.clamp(phys.mocap_pos + action[:, :3] * cfg.action_scale[0], *self._cartesian)
        if cfg.enable_rotation:
            drot = action[:, 3:6] * cfg.action_scale[1]
            angle = norm(drot) + 1e-9
            dq = quat_from_axis_angle(drot / angle[:, None], angle)
            nquat = quat_mul(dq, phys.mocap_quat)
            if self._clip_rot:
                # unwrap each angle toward the box centre (2 pi periodic), then clip
                lo, hi, centre = self._rot_box
                eul = quat_to_euler(nquat)
                two_pi = 2.0 * math.pi
                eul = eul + two_pi * torch.round((centre - eul) / two_pi)
                nquat = euler_to_quat(torch.clamp(eul, lo, hi))
        else:
            nquat = phys.mocap_quat
        g = phys.grip_ctrl / 255.0
        ng = torch.clamp(g + action[:, 6] * cfg.action_scale[2], 0.0, 1.0)
        gripper_moved = (ng - g).abs() > 0.25
        phys = engine.control_step(phys._replace(mocap_pos=npos, mocap_quat=nquat,
                                                 grip_ctrl=ng * 255.0), self.obstacles)
        return state._replace(physics=phys, t=state.t + 1), gripper_moved

    def _step_state(self, state: EnvState, action: torch.Tensor):
        """Physics and reward, no observation: (state, reward, done, info)."""
        new_state, gripper_moved = self._apply_action(state, action)
        success = self._success(new_state)
        reward = self._reward(new_state, success, gripper_moved)
        done = (new_state.t >= self.config.time_limit_steps).to(torch.float32)
        if not self.dense_shaping:
            done = torch.maximum(done, success)  # success ends the episode
        return new_state, reward, done, {"success": success}

    def _reward(self, state: EnvState, success: torch.Tensor,
                gripper_moved: torch.Tensor) -> torch.Tensor:
        """Sparse: success less the gripper penalty."""
        return success - self.config.gripper_penalty * gripper_moved.to(torch.float32)

    def step(self, state: EnvState, action: torch.Tensor):
        new_state, reward, done, info = self._step_state(state, action)
        return new_state, self._obs(new_state), reward, done, info

    def step_auto_reset(self, state: EnvState, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[ResetDraws] = None, final_obs: bool = True, dp=None):
        """Step; where an episode ends, swap in a fresh reset (every field,
        ep_id + 1). Returns (state, obs, reward, done, info), `obs` the reset
        observation for ended envs and, when `final_obs`, info["final_obs"]
        the pre-reset one. The reset runs for every env (drawn from
        `generator` unless `draws` gives them). Under data parallelism (`dp`,
        a `distributed.sharding.DataParallel`) `state` holds the rank's envs:
        the reset's draws are taken for every rank's envs and the rank keeps
        its own rows."""
        stepped, reward, done, info = self._step_state(state, action)
        if draws is None:
            draws = ResetDraws(*(None if x is None else local(x, dp) for x in
                                 self.sample_reset_draws(action.shape[0] * num_ranks(dp),
                                                         generator)))
        fresh = self._reset_state(draws)._replace(ep_id=state.ep_id + 1)
        new_state = where_state(done > 0.5, stepped, fresh)
        info = dict(info)
        if final_obs:
            info["final_obs"] = self._obs(stepped)
        return new_state, self._obs(new_state), reward, done, info

    # ------------------------------------------------------------------ #

    @staticmethod
    def _pose(kin) -> torch.Tensor:
        """(N, 6) pinch position and Euler angles from FK."""
        return torch.cat([kin.pinch_pos, quat_to_euler(mat_to_quat(kin.pinch_rmat))], -1)

    def _obs(self, state: EnvState) -> Dict:
        phys = state.physics
        kin = fk(phys.qpos, rows_alike=True)
        tcp_vel, _ = pinch_velocity(kin, phys.qvel)
        obs_state = {"tcp_pose": self._pose(kin), "tcp_vel": tcp_vel,
                     "gripper_pose": (phys.grip_ctrl / 255.0)[:, None]}
        if self.image_obs:
            front, wrist = render_cameras(phys, self.render_size)
            return {"state": obs_state, "images": {"front": front, "wrist": wrist}}
        obs_state["block_pos"] = phys.cube_pos
        return {"state": obs_state}

    def _success(self, state: EnvState) -> torch.Tensor:
        """1 where every pose dim is within its threshold, angles wrapped."""
        err = (self._pose(fk(state.physics.qpos)) - self._target).abs()
        ang = err[:, 3:]
        err = torch.cat([err[:, :3], torch.minimum(ang, 2 * math.pi - ang)], -1)
        return (err < self._threshold).all(-1).to(torch.float32)


def _bin_walls(cx: float, cy: float, half: float, height: float, thickness: float):
    """Four wall boxes ((lo, hi) corners) around a bin centred at (cx, cy)."""
    t, h = thickness, half
    return [
        # y walls (along x)
        [[cx - h - t, cy - h - t, 0.0], [cx + h + t, cy - h, height]],
        [[cx - h - t, cy + h, 0.0], [cx + h + t, cy + h + t, height]],
        # x walls (along y)
        [[cx - h - t, cy - h, 0.0], [cx - h, cy + h, height]],
        [[cx + h, cy - h, 0.0], [cx + h + t, cy + h, height]],
    ]


# the bin task's geometry (JAX's BinRelocationEnv class attributes)
FW_BIN = (0.45, 0.15)  # the forward task's target bin centre
BW_BIN = (0.45, -0.15)
BIN_HALF = 0.06
WALL_HEIGHT = 0.04
WALL_THICKNESS = 0.008
BIN_JITTER = 0.038  # the cube's offset in its source bin: up to near the walls
CUBE_REST_Z = 0.02


def bin_walls() -> np.ndarray:
    """The (8, 2, 3) float32 wall table: the forward bin's four walls, then
    the backward bin's."""
    walls = []
    for centre in (FW_BIN, BW_BIN):
        # the centres are float32 first, as the JAX package keeps them
        cx, cy = (float(v) for v in np.asarray(centre, np.float32))
        walls += _bin_walls(cx, cy, BIN_HALF, WALL_HEIGHT, WALL_THICKNESS)
    return np.asarray(walls, np.float32)


def bin_config(task_id: int) -> PoseTaskConfig:
    """The reference BinEnvConfig: a tight box spanning both bins (x +-0.07,
    z within ~0.2 of the table), roll and pitch pinned to +-0.01, yaw +-pi/6,
    action scale (0.05, 0.1, 1); the reset over the source bin, the target
    over the other."""
    fw = task_id == 0
    return PoseTaskConfig(
        target_pose=(0.45, 0.15 if fw else -0.15, 0.1, 3.14159, 0, 0),
        reset_pose=(0.45, -0.15 if fw else 0.15, 0.18, 3.14159, 0, 0),
        action_scale=(0.05, 0.1, 1.0),
        gripper_penalty=0.1,
        cartesian_lo=(0.38, -0.23, 0.012),
        cartesian_hi=(0.52, 0.23, 0.20),
        rot_lo=(_PI - 0.01, -0.01, -_PI / 6),
        rot_hi=(_PI + 0.01, 0.01, _PI / 6),
    )


class BinRelocationEnv(PandaPoseTaskEnv):
    """Forward/backward bin relocation (reference
    franka_bin_relocation.py): move the cube between two walled bins;
    `task_id` 0 = forward (into FW_BIN), 1 = backward (into BW_BIN). The
    walls are K1's obstacle input, so the cube must be carried over them."""

    def __init__(self, task_id: int = 0, dense_shaping: bool = True, image_obs: bool = False,
                 render_size: int = 128, device=None):
        super().__init__(config=bin_config(task_id), image_obs=image_obs,
                         render_size=render_size, device=device)
        self.task_id = int(task_id)
        self.dense_shaping = bool(dense_shaping)
        self.obstacles = torch.as_tensor(bin_walls(), device=self.device)
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        self._fw_bin, self._bw_bin = t(FW_BIN), t(BW_BIN)

    def target_bin(self) -> torch.Tensor:
        return self._fw_bin if self.task_id == 0 else self._bw_bin

    def source_bin(self) -> torch.Tensor:
        return self._bw_bin if self.task_id == 0 else self._fw_bin

    def sample_reset_draws(self, num_envs: int,
                           generator: Optional[torch.Generator] = None) -> ResetDraws:
        """The pose task's draws and the cube's (N, 2) jitter in its source bin."""
        draws = super().sample_reset_draws(num_envs, generator)
        jitter = (2.0 * torch.rand((num_envs, 2), generator=generator, device=self.device)
                  - 1.0) * BIN_JITTER
        return draws._replace(jitter=jitter)

    def _place_objects(self, state: EnvState, draws: ResetDraws,
                       source: Optional[torch.Tensor] = None) -> EnvState:
        """The cube at rest in the source bin (or `source`, (2,) or (N, 2)),
        offset by draws.jitter, on every reset (the auto-reset's too)."""
        return place_cube(state, self.source_bin() if source is None else source, draws.jitter)

    def _success(self, state: EnvState) -> torch.Tensor:
        return bin_success(state.physics.cube_pos, self.target_bin())

    def _reward(self, state: EnvState, success: torch.Tensor,
                gripper_moved: torch.Tensor) -> torch.Tensor:
        """With dense shaping: reach the cube, lift it over the walls, carry
        it toward the target bin, plus success, less the gripper penalty;
        otherwise the sparse reward."""
        if not self.dense_shaping:
            return super()._reward(state, success, gripper_moved)
        return bin_shaped_reward(state, success, gripper_moved, self.target_bin(),
                                 self.config.gripper_penalty)


def place_cube(state: EnvState, src: torch.Tensor, jitter: torch.Tensor) -> EnvState:
    """`state` with each env's cube at rest at src + jitter ((2,) or (N, 2)
    source-bin centres; (N, 2) offsets) on the table, and z_init at rest."""
    n = state.t.shape[0]
    xy = src.expand(n, 2) + jitter.to(src.device, torch.float32)
    z = torch.full((n, 1), CUBE_REST_Z, dtype=torch.float32, device=src.device)
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=src.device)
    phys = state.physics._replace(cube_pos=torch.cat([xy, z], -1), cube_linvel=zeros,
                                  cube_angvel=zeros.clone())
    return state._replace(physics=phys, z_init=z[:, 0].clone())


def bin_success(cube_pos: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(N,) 1.0 where the cube lies inside the target bin ((2,) or (N, 2)
    centres) and below 5 cm."""
    inside = ((cube_pos[:, :2] - target).abs() < BIN_HALF).all(-1) & (cube_pos[:, 2] < 0.05)
    return inside.to(torch.float32)


def bin_shaped_reward(state: EnvState, success: torch.Tensor, gripper_moved: torch.Tensor,
                      target: torch.Tensor, gripper_penalty: float) -> torch.Tensor:
    """0.15 exp(-20 |tcp - cube|) + 0.25 lift (over the walls) + 0.6 carry
    (toward `target`, (2,) or (N, 2)) + success - the gripper penalty."""
    tcp, cube = fk(state.physics.qpos, rows_alike=True).pinch_pos, state.physics.cube_pos
    r_reach = 0.15 * torch.exp(-20.0 * norm(tcp - cube))
    r_lift = 0.25 * torch.clamp((cube[:, 2] - 0.02) / (WALL_HEIGHT + 0.04), 0.0, 1.0)
    d0 = math.hypot(FW_BIN[0] - BW_BIN[0], FW_BIN[1] - BW_BIN[1])
    r_carry = 0.6 * torch.clamp(1.0 - norm(cube[:, :2] - target) / d0, 0.0, 1.0)
    penalty = gripper_penalty * gripper_moved.to(torch.float32)
    return r_reach + r_lift + r_carry + success - penalty
