"""Pretrain the ResNet-10 backbone that `encoder_type="resnet-pretrained"`
grafts, and write it as `resnet10_params.pkl`.

Port of the JAX package's `tools/pretrain_resnet10.py`, with its flags and
defaults. The reference downloads an ImageNet ResNet-10; here the backbone
learns a supervised proxy task on the simulator's own render path: regress
(cube_pos, tcp_pos) from 128 px front-camera frames of noisy-expert rollouts
of the pick env (16 envs x 200 steps, auto-reset; an expert step with noise
0.3 at even steps, a uniform action at odd ones: approach, grasp and lift
states seen from many arm poses).

  * `collect_frames(env, num_envs, steps, draws)`: the frames (time-major,
    (steps * num_envs, H, W, 3) uint8) and labels ((steps * num_envs, 6)) on
    the env's device: K1 once and K2 (two launches) once a step, and one
    render of the reset. Every random number is in `draws` (`frame_draws`
    takes them from a generator; the tests feed the JAX tool's).
  * `Regressor`: the ResNet-10 backbone (`resnetv1-10` with "avg" pooling:
    stages (1, 1, 1, 1), 64 filters, GroupNorm(4), no dropout) and a head
    Dense(128) -> relu -> Dense(6). Its fp32 convolutions take cuDNN's TF32
    path on the card, as every fp32 ResNet of the port does
    (`vision/encoders.py::_tf32_convs`).
  * `train_step`: the MSE on labels normalised by the mean and population
    std of all frames' labels (+1e-6), one Adam step (`make_optimizer`:
    optax.adam's arithmetic, no warm-up, decay or clipping) on explicit
    batch indices.
  * `export_backbone(model, path)`: the backbone alone in flax's graft
    layout (conv_init, norm_init, ResNetBlock_i; HWIO kernels), float16
    numpy arrays in plain dicts: the file that both packages' loaders read.

The default output is `runs/resnet10_params.pkl` (a directory git ignores):
the committed `resnet10_params.pkl` is replaced only by naming it with
`--out`.

    python -m serl_tpu_torch.tools.pretrain_resnet10 --steps 2000
    python -m serl_tpu_torch.tools.pretrain_resnet10 --device cpu --num_envs 2 \\
        --rollout_steps 3 --steps 2 --batch_size 4

Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import os
import pickle
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch import resolve_device
from serl_tpu_torch.common.optimizers import make_optimizer
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.utils.jax_params import pairs_to_tree, resnet_pairs
from serl_tpu_torch.vision.encoders import lecun_dense, resnetv1_configs

NOISE_SCALE = 0.3  # the expert's action noise at even steps


class FrameDraws(NamedTuple):
    """The random numbers of one collection of `steps` steps of N envs."""

    reset_xy: torch.Tensor  # (N, 2) the first episodes' cube positions
    auto_reset_xy: torch.Tensor  # (steps, N, 2) where an episode ends at step t
    expert_noise: torch.Tensor  # (steps, N, 4) standard normal, scaled by NOISE_SCALE
    uniform: torch.Tensor  # (steps, N, 4) the odd steps' actions, uniform in [-1, 1)


def frame_draws(env: PandaPickCubeEnv, num_envs: int, steps: int,
                generator: Optional[torch.Generator] = None) -> FrameDraws:
    """A collection's draws from `generator` (on the env's device)."""
    dev = env.device
    return FrameDraws(
        reset_xy=env.sample_reset_xy(num_envs, generator),
        auto_reset_xy=torch.stack([env.sample_reset_xy(num_envs, generator)
                                   for _ in range(steps)]),
        expert_noise=torch.randn((steps, num_envs, 4), generator=generator, device=dev),
        uniform=2.0 * torch.rand((steps, num_envs, 4), generator=generator, device=dev) - 1.0)


@torch.no_grad()
def collect_frames(env: PandaPickCubeEnv, num_envs: int, steps: int, draws: FrameDraws):
    """(frames (steps * N, H, W, 3) uint8, labels (steps * N, 6) [cube_pos,
    tcp_pos]) of the post-step (post-reset) states, time-major as the JAX
    tool stacks its scan."""
    states, _ = env.reset(num_envs, reset_xy=draws.reset_xy)
    frames, labels = [], []
    for t in range(steps):
        if t % 2 == 0:
            actions = expert_action(states, noise=NOISE_SCALE * draws.expert_noise[t])
        else:
            actions = draws.uniform[t]
        states, obs, _, _, _ = env.step_auto_reset(states, actions,
                                                   reset_xy=draws.auto_reset_xy[t],
                                                   final_obs=False)
        tcp, _, cube = engine.observe(states.physics)
        frames.append(obs["images"]["front"])
        labels.append(torch.cat([cube, tcp], -1))
    frames = torch.stack(frames)
    return frames.reshape((-1,) + tuple(frames.shape[2:])), torch.stack(labels).reshape(-1, 6)


class Regressor(nn.Module):
    """ResNet-10 backbone + small head; only the backbone is exported."""

    def __init__(self, image_size: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = resnetv1_configs["resnetv1-10"](pooling_method="avg",
                                                        image_size=image_size,
                                                        generator=generator)
        self.dense0 = lecun_dense(self.backbone.out_features, 128, generator)
        self.dense1 = lecun_dense(128, 6, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.dense1(F.relu(self.dense0(self.backbone(x, train=train))))


def label_stats(labels: torch.Tensor):
    """(mean, population std + 1e-6) over all frames' labels."""
    return labels.mean(0), labels.std(0, correction=0) + 1e-6


def train_step(model: Regressor, opt, opt_state, frames: torch.Tensor, labels: torch.Tensor,
               mu: torch.Tensor, sd: torch.Tensor, idx: torch.Tensor):
    """One Adam step on the rows at `idx`, in place; returns (opt_state,
    the loss before the step, a 0-d tensor)."""
    params = list(model.parameters())
    y = (labels[idx] - mu) / sd
    loss = ((model(frames[idx], train=True) - y) ** 2).mean()
    grads = torch.autograd.grad(loss, params)
    return opt.step(params, grads, opt_state), loss.detach()


def export_backbone(model: Regressor, path: str) -> Dict:
    """Write the backbone's float16 tree in flax's graft layout to `path`;
    returns the tree."""
    tree = pairs_to_tree(resnet_pairs(model.backbone))

    def f16(node):
        return ({k: f16(v) for k, v in node.items()} if isinstance(node, dict)
                else np.asarray(node, np.float16))

    tree = f16(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return tree


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--rollout_steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--out", default=os.path.join("runs", "resnet10_params.pkl"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Collect, train, export; returns {"losses": the (steps,) losses on the
    host, "collect_s", "train_ms_per_step" (host clock, each ending in a
    sync), "out", "frames": the collected frames, on the device}."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    env = PandaPickCubeEnv(image_obs=True, render_size=128, device=device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    frames, labels = collect_frames(env, args.num_envs, args.rollout_steps,
                                    frame_draws(env, args.num_envs, args.rollout_steps, g))
    _sync(device)
    collect_s = time.perf_counter() - t0
    n = frames.shape[0]
    print(f"collected {n} frames in {collect_s:.0f}s", flush=True)

    mu, sd = label_stats(labels)
    model = Regressor(generator=torch.Generator().manual_seed(args.seed + 1)).to(device)
    opt = make_optimizer(args.lr)
    opt_state = opt.init(list(model.parameters()))
    g_idx = torch.Generator(device=device).manual_seed(args.seed + 2)
    losses = []
    t1 = time.perf_counter()
    for step in range(args.steps):
        idx = torch.randint(0, n, (args.batch_size,), generator=g_idx, device=device)
        opt_state, loss = train_step(model, opt, opt_state, frames, labels, mu, sd, idx)
        losses.append(loss)
        if step % 200 == 0:
            print(f"step {step} loss {float(loss):.4f} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
    _sync(device)
    train_ms = (time.perf_counter() - t1) * 1e3 / max(args.steps, 1)
    losses = torch.stack(losses).cpu() if losses else torch.zeros(0)
    if len(losses):
        print(f"final loss {float(losses[-1]):.4f}", flush=True)

    tree = export_backbone(model, args.out)
    mb = os.path.getsize(args.out) / 1e6
    print(f"saved {args.out} ({mb:.1f} MB, modules: {sorted(tree)[:6]}...)", flush=True)
    return {"losses": losses, "collect_s": collect_s, "train_ms_per_step": train_ms,
            "out": args.out, "frames": frames}


if __name__ == "__main__":
    main(sys.argv[1:])
