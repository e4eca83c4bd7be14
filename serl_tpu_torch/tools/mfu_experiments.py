"""Pixel-path stem and augmentation levers: the DrQ update timed under each.

Port of the JAX package's `tools/mfu_experiments.py`, with its variants,
flags and defaults. It times `update_high_utd` alone on a fixed pixel batch
(2 cameras of 128x128x3 uint8 and a 7-dim state, batch 256 x UTD 4; the
small encoder with spatial learned embeddings, the 10-critic ensemble
subsampled to 2, LayerNorm 256x256 tanh heads) under each lever:

  baseline   the SmallEncoder as the DrQ registry builds it (bf16 convolutions)
  pad8       the input's channels zero-padded 3 -> 8 before the first conv
             (the same function: the extra kernel taps see zeros)
  s2d        the first conv as space-to-depth(2) and a 2x2 stride-1 conv over
             12 channels (a contraction of 48 taps in place of 27)
  f32        the convolutions in float32
  half_aug   the crop augmentation off

On the card a bf16 convolution over 3 input channels cannot fill a tensor-core
tile along K; `pad8` and `s2d` ask whether cuDNN then takes a tensor-core
engine for the stem. The update runs every kernel of the port's update path:
K3 (the crop, except `half_aug`) and K5 (every Dense -> LayerNorm -> tanh).

    python -m serl_tpu_torch.tools.mfu_experiments [--iters 20] [--trace DIR]
    python -m serl_tpu_torch.tools.mfu_experiments --device cpu --batch 4 --utd 2 --size 32 --iters 1

Runs on the CUDA card unless `--device cpu`. `--trace DIR` also writes one
update of each variant through `utils/timer.py::torch_profile` to
DIR/<variant>/trace.json and prints its device time and its longest kernels
by name (which engines cuDNN picked for the stem).
"""

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from serl_tpu_torch import resolve_device

IMAGE_KEYS = ("front", "wrist")
VARIANTS = ("baseline", "pad8", "s2d", "f32", "half_aug")
STATE_DIM, ACTION_DIM = 7, 4


def make_batch(seed: int, batch: int, utd: int, size: int = 128, device=None) -> Dict:
    """A fixed update batch of batch * utd rows, from a numpy seed: the state
    (n, 7) normal, each camera (n, 1, size, size, 3) uint8 in [0, 255),
    next observations the same tensors, normal actions (n, 4), zero rewards
    and dones, unit masks; on `device` ("cuda" unless given)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = batch * utd
    obs = {"state": torch.from_numpy(rng.standard_normal((n, STATE_DIM), np.float32)),
           **{k: torch.from_numpy(rng.integers(0, 255, (n, 1, size, size, 3), np.uint8))
              for k in IMAGE_KEYS}}
    obs = {k: v.to(device) for k, v in obs.items()}
    return {"observations": obs, "next_observations": dict(obs),
            "actions": torch.from_numpy(rng.standard_normal((n, ACTION_DIM),
                                                            np.float32)).to(device),
            "rewards": torch.zeros((n,), device=device),
            "masks": torch.ones((n,), device=device),
            "dones": torch.zeros((n,), device=device)}


def make_agent(variant: str, batch_example: Dict, seed: int = 0, shared: bool = False,
               no_concat: bool = False):
    """The DrQ agent of `variant` for batches like `batch_example`, on its
    device: a SmallEncoder per camera (one for both with `shared`), fed to
    the ObsEncoder's batch concat unless `no_concat`; weights from a CPU
    generator seeded with `seed`."""
    from serl_tpu_torch.agents.drq import DrQAgent
    from serl_tpu_torch.vision import encoders as enc_mod

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    obs = batch_example["observations"]
    size = tuple(obs[IMAGE_KEYS[0]].shape[-3:-1])
    generator = torch.Generator().manual_seed(int(seed))

    def build():
        return enc_mod.SmallEncoder(
            pool_method="spatial_learned_embeddings",
            compute_dtype=torch.float32 if variant == "f32" else torch.bfloat16,
            image_size=size, generator=generator,
            pad_input_channels=8 if variant == "pad8" else None,
            space_to_depth_stem=variant == "s2d")

    if shared:
        one = build()
        encoders = {k: one for k in IMAGE_KEYS}
    else:
        encoders = {k: build() for k in IMAGE_KEYS}
    net = {"activations": "tanh", "use_layer_norm": True, "hidden_dims": (256, 256)}
    return DrQAgent.create_drq(
        {k: v[:1].cpu() for k, v in obs.items()},
        batch_example["actions"][:1].cpu(),
        encoder_type="small",
        custom_encoders=encoders,
        shared_batch_concat=not no_concat,
        use_proprio=True,
        image_keys=IMAGE_KEYS,
        policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp",
                       "std_min": 1e-5, "std_max": 5.0},
        critic_network_kwargs=dict(net),
        policy_network_kwargs=dict(net),
        temperature_init=1e-2,
        critic_ensemble_size=10,
        critic_subsample_size=2,
        augment=variant != "half_aug",
        generator=generator,
        device=obs["state"].device,
    )


def bench_update(agent, batch: Dict, utd: int, iters: int,
                 generator: Optional[torch.Generator] = None) -> float:
    """Critic grad-steps/s of `agent.update_high_utd(batch, utd_ratio=utd)`:
    a warm-up call, then the best of 3 rounds of `iters` calls, each round
    ending in a device-to-host read of the critic loss."""
    if generator is None:
        generator = torch.Generator(device=batch["rewards"].device).manual_seed(0)
    _, info = agent.update_high_utd(batch, utd_ratio=utd, generator=generator)
    float(info["critic"]["critic_loss"])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            _, info = agent.update_high_utd(batch, utd_ratio=utd, generator=generator)
        float(info["critic"]["critic_loss"])
        best = min(best, time.perf_counter() - t0)
    # gradient steps: utd critic + 1 actor per call
    return iters * utd / best


def profile_update(agent, batch: Dict, utd: int, logdir: str, top: int = 6):
    """One update_high_utd traced into logdir/trace.json: (the device time of
    its kernels in ms, [(kernel, ms)] of the `top` longest by name)."""
    from torch.autograd import DeviceType

    from serl_tpu_torch.utils.timer import torch_profile

    generator = torch.Generator(device=batch["rewards"].device).manual_seed(1)
    with torch_profile(logdir) as prof:
        _, info = agent.update_high_utd(batch, utd_ratio=utd, generator=generator)
        float(info["critic"]["critic_loss"])
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda kv: -kv[1])
    return sum(ms for _, ms in kernels), kernels[:top]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--utd", type=int, default=4)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--trace", default=None)
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Each variant's critic grad-steps/s, printed, then each one's ratio to
    the baseline; returns {variant: grad-steps/s}."""
    args = parser().parse_args(argv)
    batch = make_batch(0, args.batch, args.utd, args.size, args.device)
    results = {}
    for v in args.variants.split(","):
        agent = make_agent(v, batch)
        ups = bench_update(agent, batch, args.utd, args.iters)
        results[v] = ups
        print(f"{v}: {ups:.1f} critic-grad-steps/s", flush=True)
        if args.trace:
            busy, kernels = profile_update(agent, batch, args.utd, os.path.join(args.trace, v))
            print(f"  {v} traced: {busy:.3f} device ms a call; longest kernels "
                  + "; ".join(f"{name[:100]} {ms:.3f} ms" for name, ms in kernels), flush=True)
        del agent
    base = results.get("baseline")
    if base:
        for v, r in results.items():
            print(f"{v}: {r:.1f} ({r / base:.2f}x baseline)")
    return results


if __name__ == "__main__":
    main()
