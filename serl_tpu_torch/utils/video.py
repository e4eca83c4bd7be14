"""Episode video: frame tiling, a recorder, one recorded evaluation episode.

Port of `serl_tpu/utils/video.py`. `compose_frames` tiles camera streams
into one frame sequence; `VideoRecorder` collects frames and saves them as
an animated GIF (PIL, imported only there) or an .npz of the stacked frames
(numpy only: the GPU machine has no PIL, so it saves with as_gif=False);
`record_eval_episode` rolls one argmax episode of a state agent in a
one-env batch and renders both cameras (K2) before every step (K1).
"""

import os
from typing import List, Optional

import numpy as np
import torch

MAX_EPISODE_STEPS = 100  # the JAX package's loop bound: the pick env's time limit


def compose_frames(frame_lists: List[List[np.ndarray]], cols: int = 2):
    """Tile camera streams into one frame sequence: stream i in grid cell
    divmod(i, cols), as long as the shortest stream."""
    n_streams = len(frame_lists)
    length = min(len(f) for f in frame_lists)
    rows = (n_streams + cols - 1) // cols
    out = []
    for t in range(length):
        frames = [np.asarray(f[t]) for f in frame_lists]
        h, w = frames[0].shape[:2]
        canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, fr in enumerate(frames):
            r, c = divmod(i, cols)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = fr
        out.append(canvas)
    return out


class VideoRecorder:
    """Collect frames and flush them to `save_dir/<name>.gif` or `.npz`."""

    def __init__(self, save_dir: str, fps: int = 20):
        self.save_dir = save_dir
        self.fps = fps
        os.makedirs(save_dir, exist_ok=True)
        self.frames: List[np.ndarray] = []

    def record(self, frame: np.ndarray):
        self.frames.append(np.asarray(frame))

    def save(self, name: str, as_gif: bool = True) -> Optional[str]:
        if not self.frames:
            return None
        path = os.path.join(self.save_dir, name)
        if as_gif:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            path += ".gif"
            imgs[0].save(path, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / self.fps), loop=0)
        else:
            path += ".npz"
            np.savez_compressed(path, frames=np.stack(self.frames))
        self.frames = []
        return path


@torch.no_grad()
def record_eval_episode(env, agent, generator: Optional[torch.Generator] = None,
                        reset_xy: Optional[torch.Tensor] = None, render_size: int = 128):
    """Roll one deterministic episode of `agent` (a state agent: flat
    observations, `sample_actions(argmax=True)`) in `env` (a batched pick
    env, one env here) and return its composed (front | wrist) frames, one
    per step, rendered before the step."""
    from serl_tpu_torch.envs.panda_pick import flatten_obs
    from serl_tpu_torch.envs.rendering import render_cameras

    state, obs = env.reset(1, generator, reset_xy=reset_xy)
    fronts, wrists = [], []
    for _ in range(MAX_EPISODE_STEPS):
        front, wrist = render_cameras(state.physics, render_size)
        fronts.append(front[0].cpu().numpy())
        wrists.append(wrist[0].cpu().numpy())
        action = agent.sample_actions(flatten_obs(obs), argmax=True)
        state, obs, _, done, _ = env.step(state, action)
        if float(done[0]) > 0.5:
            break
    return compose_frames([fronts, wrists])
