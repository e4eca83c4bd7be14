"""Observation wrappers for batched envs.

Port of `serl_tpu/envs/wrappers.py`: pure functions over observation
dicts, actions and batched poses (`serl_obs`, `add_stack_axis`, the
frame-stack history `ChunkState` / `chunk_init` / `chunk_push`, the
action and observation helpers, quat <-> euler, `adjoint_matrix`,
`pose_relative_to`), `act_exec_step` over a batched env, and the
learned-reward wrapper `ClassifierRewardEnv`.
"""

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from serl_tpu_torch.envs.physics.math3d import quat_conj, quat_mul, quat_to_mat, skew


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


class ChunkState(NamedTuple):
    """The rolling observation history: `frames` holds each leaf with a
    history axis T (before H, W, C for images, before the last axis
    otherwise), oldest first."""

    frames: Dict


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def chunk_init(obs: Dict, horizon: int) -> ChunkState:
    """A history of `horizon` copies of `obs`: the axis goes before the last
    three of a leaf with at least three axes (an image), else before the last."""
    def init(x):
        axis = x.dim() - (3 if x.dim() >= 3 else 1)
        return x.unsqueeze(axis).repeat_interleave(horizon, dim=axis)

    return ChunkState(frames=_map(init, obs))


def chunk_push(state: ChunkState, obs: Dict) -> ChunkState:
    """Drop the oldest entry of each history and append `obs`' leaf as the
    newest (the history axis: before the last four axes of a leaf with at
    least four, else before the last two)."""
    def push(hist, x):
        axis = hist.dim() - (4 if hist.dim() >= 4 else 2)
        return torch.cat([hist.narrow(axis, 1, hist.shape[axis] - 1), x.unsqueeze(axis)], axis)

    return ChunkState(frames=_map(push, state.frames, obs))


def act_exec_step(env, state, action_chunk: torch.Tensor):
    """Receding-horizon execution over a batched env: each env's chunk of
    `action_chunk` (N, T, action_dim) runs its T sub-actions in turn
    through `env.step`; returns (state, obs, reward, done, {"success"})
    after the last one, with the last sub-step's reward, `done` the maximum
    over the chunk and `success` the maximum of info["success"] over it (the
    JAX function's `lax.scan` over one env's (T, action_dim) chunk, vmapped)."""
    state, obs, reward, done, info = env.step(state, action_chunk[:, 0])
    success = info["success"]
    for t in range(1, action_chunk.shape[1]):
        state, obs, reward, d, info = env.step(state, action_chunk[:, t])
        done = torch.maximum(done, d)
        success = torch.maximum(success, info["success"])
    return state, obs, reward, done, {"success": success}


def front_camera_obs(obs: Dict, front_key: str = "front") -> Dict:
    """The state and one camera: the reward classifiers' view."""
    return {"state": obs["state"], front_key: obs[front_key]}


def gripper_close_action(action6: torch.Tensor) -> torch.Tensor:
    """A 6-DoF action with the gripper pinned closed (a trailing 1)."""
    return torch.cat([action6, torch.ones(action6.shape[:-1] + (1,), dtype=action6.dtype,
                                          device=action6.device)], -1)


def z_only_action(action_z_grip: torch.Tensor) -> torch.Tensor:
    """(dz, grasp) -> (0, 0, dz, grasp)."""
    zeros = torch.zeros(action_z_grip.shape[:-1] + (1,), dtype=action_z_grip.dtype,
                        device=action_z_grip.device)
    return torch.cat([zeros, zeros, action_z_grip[..., :1], action_z_grip[..., 1:2]], -1)


def unnormalize_action(action, low, high):
    """[-1, 1] -> [low, high]."""
    return 0.5 * (action + 1.0) * (high - low) + low


def normalize_proprio(proprio, low, high):
    """[low, high] -> [-1, 1]."""
    return 2.0 * (proprio - low) / (high - low) - 1.0


def remap_obs(obs: dict, mapping: dict) -> dict:
    """Rename or move observation keys: mapping new_key -> old_key, or
    (old_key, index) for one entry of the last axis."""
    out = {}
    for new_key, src in mapping.items():
        out[new_key] = obs[src[0]][..., src[1]] if isinstance(src, tuple) else obs[src]
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


def adjoint_matrix(pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """The 6x6 adjoint of the (pos, quat) transform, [[R, 0], [skew(pos) R, R]]."""
    R = quat_to_mat(quat)
    top = torch.cat([R, torch.zeros_like(R)], -1)
    bot = torch.cat([skew(pos) @ R, R], -1)
    return torch.cat([top, bot], -2)


def pose_relative_to(pose_pos, pose_quat, ref_pos, ref_quat):
    """A world pose expressed in the reference frame: (R_ref^T (p - p_ref),
    conj(q_ref) q). A batch of positions (more than one axis) takes one
    reference pose, as the JAX function does."""
    inv_q = quat_conj(ref_quat)
    R_inv = quat_to_mat(inv_q)
    if pose_pos.dim() > 1:
        rel_pos = (pose_pos - ref_pos) @ R_inv.transpose(-1, -2)
    else:
        rel_pos = R_inv @ (pose_pos - ref_pos)
    return rel_pos, quat_mul(inv_q, pose_quat)


class ClassifierRewardEnv:
    """The learned-reward wrapper over a batched pixel env (`PandaPoseTaskEnv`
    or `PandaPickCubeEnv` with `image_obs`): an env's reward is a trained
    binary classifier's verdict on the camera `image_key` of the frame it
    stepped to, sigmoid(logit) >= threshold, and that success also ends the
    episode (or the time limit does; the inner env's own `done` is
    discarded). `info["pose_success"]` keeps the inner env's success, so a
    run can report the ground truth beside the learned reward.

    `classifier` maps {image_key: (N, 1, H, W, C) uint8} to (N,) logits
    (`networks/classifier.py::classifier_fn`). The JAX package classifies one
    env at a time under vmap ({key: img[None]}, a stack of one frame that the
    encoder folds into an unbatched image); here all N envs at once, the
    same function row by row.

    `step_auto_reset` renders twice a step, as the JAX package does: the
    stepped frame, which the classifier must see because it decides `done`,
    then the observation after the reset; `final_obs=False` skips neither.
    `reset`, `time_limit_steps`, `ACTION_DIM` and the env's image settings
    pass through, and the state is the inner env's, so an expert reads it.
    """

    def __init__(self, env, classifier: Callable, image_key: str = "front",
                 threshold: float = 0.5):
        self.env = env
        self.classifier = classifier
        self.image_key = image_key
        self.threshold = threshold
        self.ACTION_DIM = getattr(env, "ACTION_DIM", 4)
        self.device = env.device
        self.image_obs = env.image_obs
        self.render_size = env.render_size

    @property
    def time_limit_steps(self) -> int:
        return self.env.time_limit_steps

    def reset(self, num_envs: int, generator: Optional[torch.Generator] = None, **kwargs):
        return self.env.reset(num_envs, generator, **kwargs)

    def classify(self, obs: Dict) -> torch.Tensor:
        """(N,) float 1.0 where sigmoid(logit) >= threshold on `obs`' frames."""
        img = obs["images"][self.image_key]
        logit = self.classifier({self.image_key: img.unsqueeze(1)})
        return (torch.sigmoid(logit) >= self.threshold).to(torch.float32)

    def step(self, state, action: torch.Tensor):
        new_state, obs, _reward, _done, info = self.env.step(state, action)
        succ = self.classify(obs)
        limit = (new_state.t >= self.time_limit_steps).to(torch.float32)
        done = torch.maximum(limit, succ)
        info = dict(info)
        info["pose_success"] = info.get("success", torch.zeros_like(succ))
        info["success"] = succ
        return new_state, obs, succ, done, info

    def _fresh(self, n: int, ep_id: torch.Tensor, generator, draws, dp=None):
        """Every env's fresh reset: a pose task's (`ResetDraws`, settled) or
        the pick env's (`draws` its (N, 2) cube positions). Under data
        parallelism (`dp`) the draws are taken for every rank's envs and the
        rank keeps its own rows."""
        from serl_tpu_torch.distributed.sharding import local, num_ranks
        from serl_tpu_torch.envs.tasks import ResetDraws

        env = self.env
        if hasattr(env, "sample_reset_draws"):
            if draws is None:
                draws = ResetDraws(*(None if x is None else local(x, dp)
                                     for x in env.sample_reset_draws(n * num_ranks(dp),
                                                                     generator)))
            return env._reset_state(draws)._replace(ep_id=ep_id)
        xy = local(env.sample_reset_xy(n * num_ranks(dp), generator), dp) if draws is None else draws
        return env._fresh(xy.to(env.device, torch.float32), ep_id)

    def step_auto_reset(self, state, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None, draws=None,
                        final_obs: bool = True, dp=None):
        """Step; where an episode ends, swap in the inner env's fresh reset
        (every field, ep_id + 1; the reset is computed for every env from
        `draws`, or drawn from `generator`, for every rank's envs under data
        parallelism, `dp`). Returns (state, obs, reward, done, info) with the
        observation after the reset, and with `final_obs` info["final_obs"],
        the stepped one."""
        from serl_tpu_torch.envs.panda_pick import where_state

        stepped, obs, reward, done, info = self.step(state, action)
        fresh = self._fresh(action.shape[0], state.ep_id + 1, generator, draws, dp)
        new_state = where_state(done > 0.5, stepped, fresh)
        # the second render: an env that did not end renders its stepped
        # state again, the same frame
        out_obs = self.env._obs(new_state)
        if final_obs:
            info["final_obs"] = obs
        return new_state, out_obs, reward, done, info
