"""Offline behaviour cloning from demonstrations, then an evaluation.

Port of `examples/bc_policy.py`, with its flags and defaults: a demo pickle
(`record_demo.py`, or the JAX package's) as a `Dataset`, a BC policy with
tanh activations, no LayerNorm, an "exp" std in [1e-5, 5] and no tanh
squash, --steps NLL steps of --batch_size rows, then `evaluate_batched` on
the pick env (--eval_episodes argmax episodes).

    python -m serl_tpu_torch.examples.record_demo --num_demos 20 --out demos.pkl
    python -m serl_tpu_torch.examples.bc_policy --demo_path demos.pkl --steps 5000

Runs on the CUDA card unless `--device cpu`.
"""

import argparse

import torch

from serl_tpu_torch.agents.bc import BCAgent
from serl_tpu_torch.common.evaluation import evaluate_batched
from serl_tpu_torch.data.dataset import Dataset
from serl_tpu_torch.data.demos import load_demos
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv

NETWORK_KWARGS = {"activations": "tanh", "use_layer_norm": False, "hidden_dims": (256, 256)}
POLICY_KWARGS = {"tanh_squash_distribution": False, "std_parameterization": "exp",
                 "std_min": 1e-5, "std_max": 5.0}
EVAL_SEED = 99


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--demo_path", required=True)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def make_agent(ds: Dataset, seed: int) -> BCAgent:
    return BCAgent.create(ds.data["observations"][:1], ds.data["actions"][:1],
                          network_kwargs=dict(NETWORK_KWARGS), policy_kwargs=dict(POLICY_KWARGS),
                          generator=torch.Generator().manual_seed(seed), device=ds.device)


def train(agent: BCAgent, ds: Dataset, steps: int, batch_size: int, seed: int, log=print):
    """`steps` BC steps on batches drawn from a generator seeded with seed + 1;
    returns the per-step NLL (a device tensor)."""
    g = torch.Generator(device=ds.device).manual_seed(seed + 1)
    nll = []
    for step in range(steps):
        _, info = agent.update(ds.sample_jax(batch_size, generator=g))
        nll.append(info["actor_loss"])
        if step % 1000 == 0:
            log(f"step {step} nll {float(info['actor_loss']):.3f} mse {float(info['mse']):.4f}")
    return torch.stack(nll) if nll else torch.zeros(0)


def main(argv=None):
    args = parser().parse_args(argv)
    trs = load_demos(args.demo_path)
    trs = {k: v for k, v in trs.items() if k not in ("ep_ids", "success")}
    ds = Dataset(trs, device=args.device)
    print(f"dataset: {ds.size} transitions")
    agent = make_agent(ds, args.seed)
    train(agent, ds, args.steps, args.batch_size, args.seed)
    env = PandaPickCubeEnv(device=args.device)
    g = torch.Generator(device=env.device).manual_seed(EVAL_SEED)
    stats = evaluate_batched(env, agent, g, num_episodes=args.eval_episodes)
    print("eval:", stats)
    return stats


if __name__ == "__main__":
    main()
