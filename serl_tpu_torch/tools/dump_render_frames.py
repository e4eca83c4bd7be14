"""Visual check of the raycaster (K2): one scripted-expert episode's frames.

Port of the JAX package's `tools/dump_render_frames.py`. Rolls the scripted
expert (no noise) through one 100-step PandaPickCube episode at N = 1 (K1
and a K2 render each step, and the reset's render), prints the episode's
final reward, success and highest cube z, and saves the front and wrist
frames side by side at the approach, grasp and lift moments of `SNAP_TS`:
PNGs where PIL is installed, else one `frames.npz` (`t<step>`: the
(2, H, W, 3) front and wrist frames).

    python -m serl_tpu_torch.tools.dump_render_frames [outdir] [--device cpu]

The default outdir is `runs/render_frames` (a directory git ignores). The
cube starts where the JAX tool's reset from PRNGKey(3) puts it
(`RESET_XY`), so the episode is the JAX tool's: the noise-free expert does
not lift the cube from there (final reward 0.016, max cube z 0.020 in both
packages, as `results/render_frames` records). Runs on the CUDA card unless
`--device cpu`.
"""

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.envs.scripted_expert import expert_action

SNAP_TS = (0, 10, 25, 40, 60, 80, 99)
EPISODE_STEPS = 100
RESET_XY = (0.2577984035015106, 0.020869553089141846)  # float32 values


@torch.no_grad()
def rollout(env: PandaPickCubeEnv, reset_xy: torch.Tensor) -> Dict[str, np.ndarray]:
    """One episode of the expert from the cube at `reset_xy` ((1, 2)): per
    step the front and wrist frames, reward, cube z and success, on the host."""
    state, _ = env.reset(1, reset_xy=reset_xy)
    steps = []
    for _ in range(EPISODE_STEPS):
        state, obs, reward, _, info = env.step(state, expert_action(state))
        steps.append({"front": obs["images"]["front"][0], "wrist": obs["images"]["wrist"][0],
                      "reward": reward[0], "cube_z": state.physics.cube_pos[0, 2],
                      "success": info["success"][0]})
    return {k: torch.stack([s[k] for s in steps]).cpu().numpy() for k in steps[0]}


def summary(outs: Dict[str, np.ndarray]) -> str:
    return (f"episode final reward={outs['reward'][-1]:.3f} "
            f"success={outs['success'].max():.0f} max_cube_z={outs['cube_z'].max():.3f}")


def save_frames(outs: Dict[str, np.ndarray], outdir: str) -> str:
    """The frames at SNAP_TS as PNGs (front | wrist), or frames.npz without
    PIL; returns the line to print."""
    os.makedirs(outdir, exist_ok=True)
    try:
        from PIL import Image

        for t in SNAP_TS:
            combo = np.concatenate([outs["front"][t], outs["wrist"][t]], axis=1)
            Image.fromarray(combo).save(os.path.join(
                outdir, f"t{t:03d}_r{outs['reward'][t]:.2f}_z{outs['cube_z'][t]:.3f}.png"))
        return f"wrote {len(SNAP_TS)} frames to {outdir}"
    except ImportError:
        np.savez(os.path.join(outdir, "frames.npz"),
                 **{f"t{t}": np.stack([outs["front"][t], outs["wrist"][t]]) for t in SNAP_TS})
        return f"PIL unavailable; wrote frames.npz to {outdir}"


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """The episode (`rollout`'s arrays); prints the summary and saves the frames."""
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?", default=os.path.join("runs", "render_frames"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env = PandaPickCubeEnv(image_obs=True, device=resolve_device(args.device))
    outs = rollout(env, torch.tensor([RESET_XY], device=env.device))
    print(summary(outs))
    print(save_frames(outs, args.outdir))
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
