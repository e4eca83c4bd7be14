"""Record scripted-expert demonstrations of the pick task to a pickle.

Port of `examples/record_demo.py`, with its flags and defaults: the
scripted pick expert with exploration noise (one (4,) draw a step, shared by
every env, as the JAX example's) plays num_demos + 10 lockstep episodes; the
first num_demos successful ones are saved as numpy arrays
(`data/demos.py::save_demos`, the JAX package's format), ready for
`bc_policy.py --demo_path` or the fused workloads.

    python -m serl_tpu_torch.examples.record_demo --num_demos 20 --out demos.pkl [--pixels]

Runs on the CUDA card unless `--device cpu`.
"""

import argparse

import torch

from serl_tpu_torch.data.demos import (
    collect_episodes,
    filter_successful,
    save_demos,
    take_transitions,
)
from serl_tpu_torch.envs.panda_pick import TIME_LIMIT_STEPS, PandaPickCubeEnv
from serl_tpu_torch.envs.scripted_expert import expert_action


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--num_demos", type=int, default=20)
    p.add_argument("--out", default="demos.pkl")
    p.add_argument("--pixels", action="store_true")
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def record(args):
    """(the kept transitions, their count)."""
    env = PandaPickCubeEnv(image_obs=args.pixels, device=args.device)

    def policy(states, g):
        noise = args.noise * torch.randn((4,), generator=g, device=env.device)
        return expert_action(states, noise)

    g = torch.Generator(device=env.device).manual_seed(args.seed)
    trs = filter_successful(collect_episodes(env, policy, g, num_episodes=args.num_demos + 10,
                                             pixel_obs=args.pixels))
    n_ok = int(trs["ep_ids"].unique().numel())
    keep = min(n_ok, args.num_demos) * TIME_LIMIT_STEPS
    return take_transitions(trs, keep), keep


def main(argv=None):
    args = parser().parse_args(argv)
    trs, keep = record(args)
    save_demos(trs, args.out)
    print(f"saved {keep} transitions ({keep // TIME_LIMIT_STEPS} successful demos) to {args.out}")


if __name__ == "__main__":
    main()
