"""The data-parallel layout's collectives, counted at 1, 2, 4 and 8 ranks.

Counterpart of `tools/scaling_analysis.py`, which counts the collectives
GSPMD put in the compiled HLO of one fused iteration. Here the collectives
are the program's own calls, counted by the `DataParallel` handle by op,
with the bytes that leave a rank (`distributed/sharding.py`): for the
state, pixel and chained fwbw programs of `examples/dryrun_multichip.py`,
each at a fixed size over 1, 2, 4 and 8 gloo ranks on the CPU, one
iteration past the learners' gates. It also checks that a replay insert
and a replay sample issue no collective (each rank keeps its own streams),
and that an iteration issues no all-gather (only the digests' check uses
one): the per-iteration traffic is the statistics' all-reduce, the
minibatch exchange (one all-to-all an update) and the gradient
all-reduces.

    python -m serl_tpu_torch.tools.scaling_analysis [--ranks 1,2,4,8] \\
        [--programs state,pixels,fwbw]

Output: one markdown table row per (program, ranks): envs per rank, calls
by op, kB by op (rank 0's).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import torch

PROGRAMS = ("state", "pixels", "fwbw")
# each program's size, the same at every rank count (the JAX tool's state
# configuration: 16 envs, batch 64 x UTD 4, 512 slots a stream)
SIZES = {
    "state": dict(num_envs=16, batch_size=64, utd_ratio=4, updates_per_iter=1,
                  training_starts=0, random_steps=0, buffer_capacity=16 * 512),
    "pixels": dict(encoder_type="small", image_size=32, num_envs=8, batch_size=8, utd_ratio=1,
                   updates_per_iter=1, training_starts=0, random_steps=0, buffer_capacity=8 * 32),
    "fwbw": dict(envs_per_task=4, batch_size=8, utd_ratio=1, training_starts=0,
                 random_steps=0, buffer_capacity=8 * 32),
}
MAX_GATE_ITERS = 64


def _ring_without_collectives(carry, info, dp) -> bool:
    """Insert a slot into the program's first ring and sample a batch from
    it: True when neither issued a collective."""
    rb, ring = info["rb"], getattr(carry, info["rings"][0])
    slot = {k: (v[0].clone() if not isinstance(v, dict) else {j: x[0].clone()
                                                               for j, x in v.items()})
            for k, v in ring.data.items()}
    dp.reset_counts()
    if isinstance(ring.insert_slot, torch.Tensor):  # a routed ring: every stream writes
        rb.insert(ring, slot, ring.ep_id[0].clone(),
                  mask=torch.ones_like(ring.ep_id[0], dtype=torch.bool))
    else:
        rb.insert(ring, slot, ring.ep_id[0].clone())
    g = torch.Generator(device=dp.device).manual_seed(0)
    rows = info["config"].batch_size * info["config"].utd_ratio
    rb.sample(ring, rows, generator=g, dp=dp)
    return not dp.counts


class Analysis:
    """A rank's task: each program built, run past its gates, then one
    iteration counted; the insert/sample check."""

    def __init__(self, programs: Sequence[str]):
        self.programs = tuple(programs)

    def __call__(self, dp) -> List[Dict]:
        from serl_tpu_torch.examples import dryrun_multichip as dm

        torch.set_num_threads(1)
        out = []
        for name in self.programs:
            carry, run_chunk, info = dm.build_program(name, dp, dp.device, dp.world_size, False,
                                                      SIZES[name])
            if name == "fwbw":
                gate = 0
                while carry.training != (True, True):
                    carry, _ = run_chunk(carry, 1)
                    gate += 1
                    if gate > MAX_GATE_ITERS:
                        raise AssertionError("fwbw: the gates did not open")
            else:
                carry, _ = run_chunk(carry, dm.first_update_iteration(info))
            dp.reset_counts()
            carry, _ = run_chunk(carry, 1)
            counts = {op: dict(c) for op, c in dp.counts.items()}
            out.append({"program": name, "ranks": dp.world_size,
                        "envs_per_rank": info["num_envs"] // dp.world_size,
                        "collectives": counts,
                        "ring_without_collectives": _ring_without_collectives(carry, info, dp)})
        return out


def row(r: Dict) -> str:
    calls = {op: c["calls"] for op, c in sorted(r["collectives"].items())}
    kb = {op: round(c["bytes"] / 1e3, 1) for op, c in sorted(r["collectives"].items())}
    return (f"| {r['program']} | {r['ranks']} | {r['envs_per_rank']} | {calls or '-'} | "
            f"{kb or '-'} |")


def check(results: Sequence[Dict]) -> None:
    """The layout's contract: no collective in an insert or a sample, no
    all-gather in an iteration, and one all-to-all an update."""
    for r in results:
        if not r["ring_without_collectives"]:
            raise AssertionError(f"{r['program']} at {r['ranks']} ranks: the replay insert or "
                                 "sample issued a collective")
        if "all_gather" in r["collectives"]:
            raise AssertionError(f"{r['program']} at {r['ranks']} ranks: an all-gather in the "
                                 "iteration")
        if r["collectives"].get("all_to_all", {}).get("calls", 0) < 1:
            raise AssertionError(f"{r['program']} at {r['ranks']} ranks: no minibatch exchange")


def analyze(ranks: int, programs: Sequence[str] = PROGRAMS) -> List[Dict]:
    """Rank 0's counts of each program over `ranks` gloo ranks on the CPU."""
    from serl_tpu_torch.examples.dryrun_multichip import launch

    return launch(Analysis(programs), ranks, "cpu", "gloo", timeout_s=900)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", default="1,2,4,8")
    p.add_argument("--programs", default=",".join(PROGRAMS))
    args = p.parse_args(argv)
    programs = [n for n in args.programs.split(",") if n]
    print("| program | ranks | envs per rank | calls by op | kB by op (rank 0) |")
    print("| --- | --- | --- | --- | --- |")
    results = []
    for n in (int(x) for x in args.ranks.split(",")):
        for r in analyze(n, programs):
            results.append(r)
            print(row(r), flush=True)
    check(results)
    print("the layout holds: replay inserts and samples are rank-local, one all-to-all an "
          "update, no all-gather in an iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
