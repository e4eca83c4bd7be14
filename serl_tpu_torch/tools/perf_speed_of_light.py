"""Speed of light of the DrQ pixel update: its convolution tower alone, then
the whole update, with a FLOP count of the work each call does.

Port of the JAX package's `tools/perf_speed_of_light.py`, with its variants,
flags and defaults (batch 256 x UTD 4, two 128 px cameras, iterations 15):

  sol      the two-camera encoder tower alone, critic-shaped: per UTD
           minibatch the obs forward and backward through autograd, then the
           next-obs forward under no_grad, on the update's exact shapes; the
           grads' sum of squares consumes the backward
  update   the real `update_high_utd` (UTD critic updates, then the actor
           step, the crop on)
  shared   the update with one encoder shared by both cameras (the
           ObsEncoder's batch concat)
  shared2  the shared encoder applied per camera (no concat)

The count (`counted_flops`) is the work of the whole call: every minibatch
of the UTD loop, the actor step and the next-obs passes, from
torch.utils.flop_counter.FlopCounterMode (aten mm, bmm, convolution and
convolution_backward) plus the Dense products of K5, which a ctypes launch
hides from it (`networks/dense_layer_norm_tanh.py::flops`). It reads the
same on the card and on the CPU, kernels or plain versions. Each line also
gives the count of one UTD minibatch's body with the rest of the call (the
update: one critic minibatch update and the actor step), the figure the JAX
tool's XLA cost model reports, since that model counts a `lax.scan` body
once whatever its trip count. The share of peak is printed against a named
card's bf16 dense tensor-core peak only.

    python -m serl_tpu_torch.tools.perf_speed_of_light [--iters 15] [--trace DIR]
    python -m serl_tpu_torch.tools.perf_speed_of_light --device cpu --batch 4 --utd 2 --size 32 --iters 1

Runs on the CUDA card unless `--device cpu`. `--trace DIR` writes one update
through `utils/timer.py::torch_profile` to DIR/trace.json and prints its
device time and longest kernels.
"""

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from serl_tpu_torch import resolve_device
from serl_tpu_torch.tools.mfu_experiments import (
    IMAGE_KEYS,
    bench_update,
    make_agent,
    make_batch,
    profile_update,
)

# NVIDIA H100 SXM5 80GB HBM3: 989.4 TFLOP/s of dense bf16 on the tensor cores
# (NVIDIA H100 Tensor Core GPU datasheet; 1,979 with 2:4 sparsity), by the
# name torch.cuda.get_device_name gives the card
H100_SXM_BF16_DENSE_PEAK = 989.4e12
BF16_DENSE_PEAK = {"NVIDIA H100 80GB HBM3": H100_SXM_BF16_DENSE_PEAK}


def _first_leaf(out):
    while isinstance(out, (tuple, list, dict)):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return out


def _fetch(out) -> float:
    """A device-to-host read of one element of `out`'s first tensor."""
    leaf = _first_leaf(out)
    return float(leaf.reshape(-1)[0]) if isinstance(leaf, torch.Tensor) else float(leaf)


def time_fn(fn, args, iters: int) -> float:
    """Seconds per `fn(*args)`: a warm-up call, then the best of 3 rounds of
    `iters` calls, each round ending in a device-to-host read."""
    _fetch(fn(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _fetch(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def counted_flops(fn, *args) -> int:
    """The float operations of one `fn(*args)` (which runs once): aten's
    products and convolutions, forward and backward, by FlopCounterMode, and
    the Dense products of the K5 kernels launched meanwhile. On the CPU K5's
    plain version multiplies by torch.matmul, which FlopCounterMode counts,
    and adds nothing to K5's tally, so either path reads the same work."""
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

    counter = FlopCounterMode(display=False)
    k5.flops = 0
    try:
        with counter:
            fn(*args)
        return counter.get_total_flops() + k5.flops
    finally:
        k5.flops = None


def peak_share(flops_per_s: float, device: torch.device) -> str:
    """'= x% of <card> bf16 dense peak', or 'no peak for <name>'."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    peak = BF16_DENSE_PEAK.get(name)
    if peak is None:
        return f"no peak for {name}"
    return f"= {100 * flops_per_s / peak:.2f}% of the {name} bf16 dense peak"


def sol_encoders(size: int, device, seed: int = 0) -> Dict[str, torch.nn.Module]:
    """One SmallEncoder a camera (spatial learned embeddings, bf16
    convolutions), weights from a CPU generator."""
    from serl_tpu_torch.vision.encoders import SmallEncoder

    g = torch.Generator().manual_seed(seed)
    return {k: SmallEncoder(pool_method="spatial_learned_embeddings",
                            compute_dtype=torch.bfloat16, image_size=(size, size),
                            generator=g).to(device) for k in IMAGE_KEYS}


def sol_tower(enc: Dict[str, torch.nn.Module], obs_all: Dict, next_all: Dict) -> torch.Tensor:
    """The critic-shaped tower over obs_all's leading UTD axis: per minibatch
    the loss sum(f^2) of both cameras' features, its grads by autograd, the
    next-obs features under no_grad; returns the sum of the losses, the
    next-obs features and the grads' squares."""
    params = [p for k in IMAGE_KEYS for p in enc[k].parameters()]
    acc = torch.zeros((), device=params[0].device)
    for i in range(next(iter(obs_all.values())).shape[0]):
        feats = [enc[k](obs_all[k][i]) for k in IMAGE_KEYS]
        loss = sum((f.float() ** 2).sum() for f in feats)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            tgt = [enc[k](next_all[k][i]) for k in IMAGE_KEYS]
        l = loss.detach() + sum(t.float().sum() for t in tgt)
        # consume the grads, as the JAX tool does to keep XLA from dropping the backward
        gsum = sum((g.float() ** 2).sum() for g in grads)
        acc = acc + l + gsum
    return acc


def sol_bench(batch_size: int, utd: int, iters: int, size: int = 128, device=None):
    """(seconds per call, float operations per call) of `sol_tower` on
    (utd, batch_size, size, size, 3) uint8 images of both cameras (next_obs
    the same tensors), from a numpy seed; the count is all utd minibatches'."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    enc = sol_encoders(size, device)
    obs_all = {k: torch.from_numpy(rng.integers(0, 255, (utd, batch_size, size, size, 3),
                                                np.uint8)).to(device) for k in IMAGE_KEYS}
    next_all = dict(obs_all)
    flops = counted_flops(sol_tower, enc, obs_all, next_all)
    dt = time_fn(sol_tower, (enc, obs_all, next_all), iters)
    return dt, flops


def critic_body_flops(agent, batch: Dict, utd: int, generator: torch.Generator) -> int:
    """The float operations of one critic minibatch update of `batch` (its
    first batch / utd rows): one pass of the JAX update's scan body."""
    from serl_tpu_torch.agents.sac import SACAgent

    rows = batch["rewards"].shape[0] // utd
    mini = {k: ({kk: vv[:rows] for kk, vv in v.items()} if isinstance(v, dict) else v[:rows])
            for k, v in batch.items()}
    return counted_flops(lambda: SACAgent.update(agent, mini,
                                                 networks_to_update=frozenset({"critic"}),
                                                 generator=generator))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--utd", type=int, default=4)
    p.add_argument("--trace", default=None)
    p.add_argument("--variants", default="sol,update,shared,shared2")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--device", default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Prints a line per variant; returns {variant: {"seconds" (a call),
    "flops" (a call), "body_flops", "flops_per_s", ...}}."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    variants = args.variants.split(",")
    out = {}

    if "sol" in variants:
        dt, flops = sol_bench(args.batch, args.utd, args.iters, args.size, device)
        body = flops // args.utd  # every minibatch of the loop does the same work
        tf = flops / dt
        out["sol"] = {"seconds": dt, "flops": flops, "body_flops": body, "flops_per_s": tf}
        print(f"sol: {dt * 1e3:.1f} ms / {args.utd}-minibatch critic conv tower "
              f"({flops / 1e9:.2f} GFLOP a call, {body / 1e9:.2f} GFLOP a minibatch) -> "
              f"{tf / 1e12:.2f} TFLOP/s {peak_share(tf, device)}", flush=True)

    batch = make_batch(0, args.batch, args.utd, args.size, device)

    def measure_update(variant_name, **agent_kwargs):
        agent = make_agent("baseline", batch, **agent_kwargs)
        ups = bench_update(agent, batch, args.utd, args.iters)
        g = torch.Generator(device=device).manual_seed(1)
        flops = counted_flops(lambda: agent.update_high_utd(batch, utd_ratio=args.utd,
                                                            generator=g))
        # the JAX tool's figure: one critic minibatch update and the actor step
        body = flops - (args.utd - 1) * critic_body_flops(agent, batch, args.utd, g)
        per_call = args.utd / ups  # seconds per update_high_utd call
        tf = flops / per_call
        out[variant_name] = {"grad_steps_s": ups, "seconds": per_call, "flops": flops,
                             "body_flops": body, "flops_per_s": tf}
        print(f"{variant_name}: {ups:.1f} critic-grad-steps/s ({flops / 1e9:.2f} GFLOP a "
              f"call, {body / 1e9:.2f} GFLOP with one critic minibatch) -> {tf / 1e12:.2f} "
              f"TFLOP/s {peak_share(tf, device)}", flush=True)
        return agent

    agent = None
    if "update" in variants:
        agent = measure_update("update")
    if "shared" in variants:
        measure_update("shared", shared=True)
    if "shared2" in variants:
        measure_update("shared2", shared=True, no_concat=True)

    if args.trace and agent is not None:
        busy, kernels = profile_update(agent, batch, args.utd, args.trace)
        out["update"]["traced_device_ms"] = busy
        print(f"trace written to {args.trace}/trace.json: {busy:.3f} device ms; longest kernels "
              + "; ".join(f"{name[:100]} {ms:.3f} ms" for name, ms in kernels))
    return out


if __name__ == "__main__":
    main()
