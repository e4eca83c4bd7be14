"""Observation wrappers for batched envs.

Port of `serl_obs`, `add_stack_axis`, `quat_to_euler`, `euler_to_quat` and
`ClassifierRewardEnv` from `serl_tpu/envs/wrappers.py`: pure functions over
observation dicts and batched quaternions, and the learned-reward wrapper
over a batched env. (`chunk_init`/`chunk_push`, the loop's frame-stack
history, `act_exec_step`, `adjoint_matrix` and `pose_relative_to` are not
ported yet.)
"""

from typing import Callable, Dict, Optional, Tuple

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

    def _fresh(self, n: int, ep_id: torch.Tensor, generator, draws):
        """Every env's fresh reset: a pose task's (`ResetDraws`, settled) or
        the pick env's (`draws` its (N, 2) cube positions)."""
        env = self.env
        if hasattr(env, "sample_reset_draws"):
            draws = env.sample_reset_draws(n, generator) if draws is None else draws
            return env._reset_state(draws)._replace(ep_id=ep_id)
        xy = env.sample_reset_xy(n, generator) if draws is None else draws
        return env._fresh(xy.to(env.device, torch.float32), ep_id)

    def step_auto_reset(self, state, action: torch.Tensor,
                        generator: Optional[torch.Generator] = None, draws=None,
                        final_obs: bool = True):
        """Step; where an episode ends, swap in the inner env's fresh reset
        (every field, ep_id + 1; the reset is computed for every env from
        `draws`, or drawn from `generator`). Returns (state, obs, reward,
        done, info) with the observation after the reset, and with
        `final_obs` info["final_obs"], the stepped one."""
        from serl_tpu_torch.envs.panda_pick import where_state

        stepped, obs, reward, done, info = self.step(state, action)
        fresh = self._fresh(action.shape[0], state.ep_id + 1, generator, draws)
        new_state = where_state(done > 0.5, stepped, fresh)
        # the second render: an env that did not end renders its stepped
        # state again, the same frame
        out_obs = self.env._obs(new_state)
        if final_obs:
            info["final_obs"] = obs
        return new_state, out_obs, reward, done, info
