"""Chained forward/backward bin relocation: one batch of reset-free envs whose
active task flips at success.

Port of `serl_tpu/envs/chained_bin.py` (the reference's E6 structure): at
an episode's end the next task is the other one if the active task's
success fired (the reference wrapper's `task_graph`), else the same task
retries; the arm returns to the next task's reset pose with the gripper
open while the cube stays where it lies. A full fresh reset (arm
re-initialised, cube in the drawn task's source bin) replaces the chained
one where the cube left the arm's reach ("lost") or with probability
`fresh_reset_prob`, and re-draws the task uniformly. Reward, termination
and the switch run on the ground-truth bin membership, or on learned
per-task classifiers of the front camera (`classifier_fns`), with the
ground truth kept in info["success_gt"].

Every env is stepped at once (the JAX package vmaps one env): `task` is an
(N,) int32 tensor, and every choice is a per-env `torch.where`. An env step
is one control step (K1, with the bin walls) and, for every env, the
candidate reset's 5 settle steps: 6 K1 launches and no host sync. The JAX
env draws its reset's numbers from fold_in(rng, ep_id) per env; here they
are the caller's `generator`'s, or explicit `ChainDraws` (the tests feed
JAX's). The classifiers see the front camera of the stepped, pre-reset
state, all N envs in one call. `final_obs` is rendered only where the
caller asks for it.
"""

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from serl_tpu_torch.distributed.sharding import local, num_ranks
from serl_tpu_torch.envs.panda_pick import EnvState, _where, where_state
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.rendering import render_cameras
from serl_tpu_torch.envs.tasks import (
    BIN_JITTER,
    CUBE_REST_Z,
    SETTLE_STEPS,
    BinRelocationEnv,
    ResetDraws,
    bin_shaped_reward,
    bin_success,
    place_cube,
)
from serl_tpu_torch.envs.wrappers import euler_to_quat

CLS_KEY = "front"  # the classifiers' camera


class ChainedState(NamedTuple):
    env: EnvState
    task: torch.Tensor  # (N,) int32: 0 = forward, 1 = backward


class ChainDraws(NamedTuple):
    """The random numbers of one chained reset of N envs."""

    dxy: torch.Tensor  # (N, 2) reset-pose xy offset, uniform in +-random_xy_range
    jitter: torch.Tensor  # (N, 2) a fresh cube's offset in its source bin, uniform in +-BIN_JITTER
    fresh: torch.Tensor  # (N,) uniform: a fresh reset where < fresh_reset_prob
    task: torch.Tensor  # (N,) int: a fresh reset's task, uniform over {0, 1}


def where_chained(mask: torch.Tensor, a: ChainedState, b: ChainedState) -> ChainedState:
    """b where the (N,) mask is set, else a."""
    return ChainedState(where_state(mask, a.env, b.env), torch.where(mask, b.task, a.task))


class ChainedBinEnv:
    """Reset-free dual-task bin relocation (see the module docstring).

    `classifier_fns`: optional (fw_fn, bw_fn), each mapping {"front": (N, 1,
    H, W, 3) uint8} to (N,) logits (`networks/classifier.py::classifier_fn`);
    sigmoid(logit) >= `classifier_threshold` then drives reward, termination
    and the task switch."""

    ACTION_DIM = 7

    def __init__(self, dense_shaping: bool = False, image_obs: bool = False,
                 render_size: int = 128, fresh_reset_prob: float = 0.05,
                 classifier_fns: Optional[Tuple[Callable, Callable]] = None,
                 classifier_threshold: float = 0.5, device=None):
        kw = dict(dense_shaping=dense_shaping, image_obs=image_obs, render_size=render_size,
                  device=device)
        self.fw = BinRelocationEnv(task_id=0, **kw)
        self.bw = BinRelocationEnv(task_id=1, **kw)
        self.device = self.fw.device
        self.image_obs = bool(image_obs)
        self.render_size = int(render_size)
        self.dense_shaping = bool(dense_shaping)
        self.fresh_reset_prob = float(fresh_reset_prob)
        self.classifier_fns = classifier_fns
        # a raised threshold is the lever against per-step false positives: an
        # episode ends (and the task flips) on the first positive
        self.classifier_threshold = float(classifier_threshold)
        self.obstacles = self.fw.obstacles
        # per task (row 0 forward, row 1 backward): reset pose, target and source bins
        self._reset_poses = torch.stack([self.fw._reset_pose, self.bw._reset_pose])
        self._targets = torch.stack([self.fw.target_bin(), self.bw.target_bin()])
        self._sources = torch.stack([self.fw.source_bin(), self.bw.source_bin()])

    @property
    def time_limit_steps(self) -> int:
        return self.fw.config.time_limit_steps

    def target_bins(self, task: torch.Tensor) -> torch.Tensor:
        """(N, 2) the target bin of each env's task."""
        return self._targets[task.long()]

    # ------------------------------------------------------------------ #

    def sample_reset_draws(self, num_envs: int,
                           generator: Optional[torch.Generator] = None) -> ResetDraws:
        """A full reset's draws (the bin task's, shared by both tasks)."""
        return self.fw.sample_reset_draws(num_envs, generator)

    def sample_chain_draws(self, num_envs: int,
                           generator: Optional[torch.Generator] = None) -> ChainDraws:
        u = lambda *shape: torch.rand(shape, generator=generator, device=self.device)
        r = self.fw.config.random_xy_range
        return ChainDraws(
            dxy=(2.0 * u(num_envs, 2) - 1.0) * r,
            jitter=(2.0 * u(num_envs, 2) - 1.0) * BIN_JITTER,
            fresh=u(num_envs),
            task=torch.randint(0, 2, (num_envs,), generator=generator, device=self.device),
        )

    def _reset_state(self, draws: ResetDraws, task: torch.Tensor) -> EnvState:
        """The bin task's reset, each env with its own task's pose and bin."""
        return self.fw._reset_state(draws, pose=self._reset_poses[task.long()],
                                    source=self._sources[task.long()])

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
              task: Optional[int] = None, draws: Optional[ResetDraws] = None,
              task_draw: Optional[torch.Tensor] = None):
        """A full fresh reset of `num_envs` envs; `task` None draws each env's
        starting task uniformly (from `generator`, or `task_draw`)."""
        if draws is None:
            draws = self.sample_reset_draws(num_envs, generator)
        if task is not None:
            t = torch.full((num_envs,), int(task), dtype=torch.int32, device=self.device)
        elif task_draw is not None:
            t = task_draw.to(self.device, torch.int32)
        else:
            t = torch.randint(0, 2, (num_envs,), generator=generator, device=self.device,
                              dtype=torch.int32)
        state = ChainedState(env=self._reset_state(draws, t), task=t)
        return state, self._obs(state)

    def _obs(self, state: ChainedState) -> Dict:
        # the observation is task-independent: each policy sees the same dict
        return self.fw._obs(state.env)

    # ------------------------------------------------------------------ #

    def _success_pair(self, es: EnvState):
        """(driving_fw, driving_bw, gt_fw, gt_bw): the driving pair is what
        reward, termination and the task graph run on (the classifiers on the
        front camera of `es` when given, else the ground truth)."""
        cube = es.physics.cube_pos
        gt_fw, gt_bw = bin_success(cube, self._targets[0]), bin_success(cube, self._targets[1])
        if self.classifier_fns is None:
            return gt_fw, gt_bw, gt_fw, gt_bw
        front, _ = render_cameras(es.physics, self.render_size)
        frames = {CLS_KEY: front.unsqueeze(1)}
        fw_fn, bw_fn = self.classifier_fns
        thr = self.classifier_threshold
        d_fw = (torch.sigmoid(fw_fn(frames)) >= thr).to(torch.float32).reshape(-1)
        d_bw = (torch.sigmoid(bw_fn(frames)) >= thr).to(torch.float32).reshape(-1)
        return d_fw, d_bw, gt_fw, gt_bw

    def _chain_or_fresh_reset(self, es: EnvState, next_task: torch.Tensor,
                              draws: ChainDraws) -> Tuple[EnvState, torch.Tensor]:
        """Every env's candidate post-episode state and task: the arm
        retargeted to the next task's reset pose with the gripper open and
        the cube untouched, or (where the cube is lost, or with
        fresh_reset_prob) a fresh reset into a re-drawn task; both settle in
        one 5-step run."""
        n = next_task.shape[0]
        f32 = lambda x: x.to(self.device, torch.float32)
        dxy = f32(draws.dxy)
        pose = self._reset_poses[next_task.long()]
        chained = es.physics._replace(
            mocap_pos=torch.cat([pose[:, :2] + dxy, pose[:, 2:3]], -1),
            mocap_quat=euler_to_quat(pose[:, 3:]),
            grip_ctrl=torch.zeros_like(es.physics.grip_ctrl))

        # "lost": outside the zone the arm can grasp in (the safety box clips
        # the mocap to x [0.38, 0.52], y [-0.23, 0.23])
        cube = es.physics.cube_pos
        lost = ((cube[:, 0] < 0.383) | (cube[:, 0] > 0.517) | (cube[:, 1].abs() > 0.226)
                | (cube[:, 2] > 0.30) | (cube[:, 2] < -0.05))
        use_fresh = lost | (f32(draws.fresh) < self.fresh_reset_prob)
        # a fresh reset re-draws the task, so that every stream visits both tasks
        out_task = torch.where(use_fresh, draws.task.to(self.device, torch.int32),
                               next_task).to(torch.int32)
        fresh_pose = self._reset_poses[out_task.long()]
        fresh = engine.init_state(torch.zeros((n, 2), dtype=torch.float32, device=self.device))
        fresh = fresh._replace(
            mocap_pos=torch.cat([fresh_pose[:, :2] + dxy, fresh_pose[:, 2:3]], -1),
            mocap_quat=euler_to_quat(fresh_pose[:, 3:]))
        fresh = place_cube(es._replace(physics=fresh), self._sources[out_task.long()],
                           draws.jitter).physics
        phys = engine.PhysicsState(*(_where(use_fresh, c, f) for c, f in zip(chained, fresh)))
        for _ in range(SETTLE_STEPS):
            phys = engine.control_step(phys, self.obstacles)
        reset_es = es._replace(physics=phys, t=torch.zeros_like(es.t), ep_id=es.ep_id + 1,
                               z_init=torch.full_like(es.z_init, CUBE_REST_Z))
        return reset_es, out_task

    def step_auto_reset(self, state: ChainedState, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[ChainDraws] = None, final_obs: bool = True, dp=None):
        """One chained control step with the task graph and the reset.
        Returns (state, obs, reward, done, info); info holds "success" (the
        driving success of the task that owned the step), "success_gt",
        "task" (that task: it routes the transition), "switched" (the
        episode ended with a task flip) and, when `final_obs`, "final_obs"
        (the pre-reset observation). Under data parallelism (`dp`, a
        `distributed.sharding.DataParallel`) `state` holds the rank's envs:
        the reset's draws are taken for every rank's envs and the rank keeps
        its own rows."""
        es, task = state.env, state.task
        new_es, gripper_moved = self.fw._apply_action(es, action)
        d_fw, d_bw, gt_fw, gt_bw = self._success_pair(new_es)
        is_fw = task == 0
        success = torch.where(is_fw, d_fw, d_bw)
        success_gt = torch.where(is_fw, gt_fw, gt_bw)
        penalty = self.fw.config.gripper_penalty
        if self.dense_shaping:
            reward = bin_shaped_reward(new_es, success, gripper_moved, self.target_bins(task),
                                       penalty)
        else:
            reward = success - penalty * gripper_moved.to(torch.float32)

        done = (new_es.t >= self.time_limit_steps).to(torch.float32)
        if not self.dense_shaping:
            done = torch.maximum(done, success)
        # the task graph: flip on success, else retry
        next_task = torch.where(success > 0.5, 1 - task, task).to(torch.int32)
        if draws is None:
            draws = ChainDraws(*(local(x, dp) for x in
                                 self.sample_chain_draws(task.shape[0] * num_ranks(dp), generator)))
        reset_es, reset_task = self._chain_or_fresh_reset(new_es, next_task, draws)
        is_done = done > 0.5
        out = ChainedState(where_state(is_done, new_es, reset_es),
                           torch.where(is_done, reset_task, task))
        info = {"success": success, "success_gt": success_gt, "task": task,
                "switched": is_done & (next_task != task)}
        if final_obs:
            info["final_obs"] = self.fw._obs(new_es)
        return out, self._obs(out), reward, done, info
