"""Which op makes the bin task's observations round differently by row count.

    python3 tests/bin_obs_rounding.py [--device cpu]

On 2 data-parallel ranks the physics (K1) of the bin relocation task stays
bit for bit with one rank, while its observations could drift apart: a rank
holds 4 envs where one rank holds 8. This script takes 128 envs of
`BinRelocationEnv` after a few random steps and:
  * runs the observation (`_obs`), the reward, `fk` (the physics' form and
    the observations' `rows_alike` form) and `pinch_velocity` on the first 8
    rows and on the first 4, records every torch call of each
    (a TorchFunctionMode) and names the first call whose output's rows
    differ bit for bit, with its shapes (null: none differs);
  * compares `_obs` and the reward on the first n rows with the same rows
    at 128, for n in ROWS;
  * runs each candidate formulation of the small batched products (the `@`
    of (N, 3, 3) by (3,), by one (3, 3), by (N, 3, 3), of (N, 6, 7) by
    (N, 7)) at every n in ROWS against its first rows at 128, and times
    each at 128 rows (CUDA events over 200 calls).
Prints one JSON line of the findings, then the card's name and power limit.
Imports torch and the port only.
"""

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.overrides import TorchFunctionMode

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from serl_tpu_torch.envs.physics import arm  # noqa: E402
from serl_tpu_torch.envs.tasks import BinRelocationEnv  # noqa: E402

ROWS = (1, 2, 4, 8, 16, 32, 64, 128)


class _Record(TorchFunctionMode):
    """Every torch call's name and tensor outputs, in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                   if isinstance(t, torch.Tensor)]
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        self.calls.append((getattr(func, "__name__", str(func)), shapes,
                           [t.detach().clone() for t in tensors]))
        return out


def _record(fn, *args):
    with _Record() as rec:
        fn(*args)
    return rec.calls


def _rows(state, n):
    return type(state)(*(_rows(x, n) if isinstance(x, tuple) else x[:n] for x in state))


def first_difference(fn, state, n: int):
    """The first recorded call of fn(state) whose output's first n rows
    differ from fn(first n rows of state)'s, or None."""
    full, part = _record(fn, state), _record(fn, _rows(state, n))
    if len(full) != len(part):
        return {"error": f"{len(full)} calls against {len(part)}"}
    for i, ((name, shapes, outs), (_, pshapes, pouts)) in enumerate(zip(full, part)):
        for a, b in zip(outs, pouts):
            if a.dim() and a.shape[0] == state.t.shape[0] and a.shape[1:] == b.shape[1:]:
                if not torch.equal(a[:n], b):
                    return {"call": i, "op": name, "shapes_full": shapes, "shapes_part": pshapes,
                            "max_abs_diff": float((a[:n].double() - b.double()).abs().max())}
    return None


def _candidates():
    """name -> (fn(full inputs) -> output, inputs maker(n, g, device))."""
    mv = lambda n, g, d: (torch.randn((n, 3, 3), generator=g, device=d),
                          torch.randn((3,), generator=g, device=d))
    mm = lambda n, g, d: (torch.randn((n, 3, 3), generator=g, device=d),
                          torch.randn((n, 3, 3), generator=g, device=d))
    mc = lambda n, g, d: (torch.randn((n, 3, 3), generator=g, device=d),
                          torch.randn((3, 3), generator=g, device=d))
    jq = lambda n, g, d: (torch.randn((n, 6, 7), generator=g, device=d),
                          torch.randn((n, 7), generator=g, device=d))
    return {
        "R @ v (matmul)": (lambda R, v: R @ v, mv),
        "R @ v (mul, sum)": (lambda R, v: (R * v).sum(-1), mv),
        "R @ v (three products)": (lambda R, v: R[..., 0] * v[0] + R[..., 1] * v[1]
                                   + R[..., 2] * v[2], mv),
        "R @ C, one C (matmul)": (lambda R, C: R @ C, mc),
        "R @ C, one C (rotate_by)": (arm.rotate_by, mc),
        "A @ B (matmul)": (lambda A, B: A @ B, mm),
        "A @ B (mul, sum)": (lambda A, B: (A[..., :, :, None] * B[..., None, :, :]).sum(-2), mm),
        "J @ qd (matmul)": (lambda J, q: (J @ q[..., None])[..., 0], jq),
        "J @ qd (mul, sum)": (lambda J, q: (J * q[..., None, :]).sum(-1), jq),
    }


def _per_call_ms(fn, calls: int = 200) -> float:
    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def candidate_rows(device):
    """For each formulation, the row counts whose result differs from the
    first rows of the 128-row result, and (on the card) its ms a call."""
    out = {}
    for name, (fn, make) in _candidates().items():
        g = torch.Generator(device=device).manual_seed(0)
        inputs = make(max(ROWS), g, device)
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            full = fn(*inputs)
            out[name] = {"rows_differing": [n for n in ROWS if not torch.equal(
                fn(*(x[:n] if x.shape[0] == max(ROWS) else x for x in inputs)), full[:n])]}
            if device.type == "cuda":
                out[name]["ms_at_128"] = _per_call_ms(lambda: fn(*inputs))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    env = BinRelocationEnv(0, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    state, _ = env.reset(max(ROWS), g)
    for _ in range(args.steps):
        state, _, _, _, _ = env.step(state, 2 * torch.rand((max(ROWS), 7), generator=g,
                                                           device=device) - 1)
    obs = lambda s: env._obs(s)
    kin = lambda s: arm.fk(s.physics.qpos)
    kin_alike = lambda s: arm.fk(s.physics.qpos, rows_alike=True)
    vel = lambda s: arm.pinch_velocity(arm.fk(s.physics.qpos, rows_alike=True), s.physics.qvel)
    reward = lambda s: env._reward(s, env._success(s), torch.zeros_like(s.t, dtype=torch.bool))
    eight = _rows(state, 8)
    flat = lambda s: torch.cat([obs(s)["state"][k] for k in sorted(obs(s)["state"])] +
                               [reward(s)[:, None]], -1)
    full = flat(state)
    findings = {"device": str(device),
                "first_difference_4_of_8": {name: first_difference(fn, eight, 4) for name, fn in
                                            (("_obs", obs), ("fk", kin),
                                             ("fk rows_alike", kin_alike),
                                             ("pinch_velocity", vel), ("reward", reward))},
                "obs_and_reward_rows_differing_from_128": [
                    n for n in ROWS if not torch.equal(flat(_rows(state, n)), full[:n])],
                "candidates": candidate_rows(device)}
    print(json.dumps(findings))
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
