"""The learning check: an RLPD workload, several seeds at once.

Starts the example `--example` (`fused_sac_state_sim`, RLPD on the state
workload, by default; `fused_drq_sim`, RLPD from pixels, both with `--rlpd`
and the preset `--preset`, the example's own by default: `state_sim`, or
`drq_rlpd` for the pixel example; or `fused_peg_insert`, peg insertion from
states or with `--pixels` from pixels; or `fused_cable_route`, cable route
on the learned classifier's reward; or `vice_online`, each recipe as it
is) once per seed,
all concurrently on one card (the loop is host-bound, so they overlap), and
when all have ended writes `<out>/summary.json`: per seed, the evaluations
(env steps, eval success and return), the env step at which the seed was
solved (two evaluations in a row at or above --success_stop) or null, and
the last logged env-steps/s; with the card's name and power limit.

    python -m serl_tpu_torch.examples.learning_check --out runs/learning \\
        --seeds 0 1 2 --total_env_steps 200000 --success_stop 0.97
    python -m serl_tpu_torch.examples.learning_check --out runs/pixels \\
        --example fused_drq_sim --total_env_steps 96000 --success_stop 0.9
    python -m serl_tpu_torch.examples.learning_check --out runs/peg_pixels \
        --example fused_peg_insert --pixels --total_env_steps 96000 --success_stop 0.9
    python -m serl_tpu_torch.examples.learning_check --out runs/cable_route \
        --example fused_cable_route --total_env_steps 60000 --success_stop 0.9

A cable-route seed's evaluations carry the classifier's success beside the
ground truth, and its summary the classifier's data counts and last
accuracy; a VICE seed's, the share of episodes the classifier rated a
success and its BCE.

Each seed's output goes to <out>/seed<S>.log and its chunk logs to
<out>/seed<S>/*.jsonl. Exits non-zero if a seed's process fails.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

# CPU threads of each seed's process: the seeds run at once, share the
# host's cores, and each seed's loop is host-bound
THREADS_PER_SEED = 2
# each RLPD example's preset unless --preset names another; the pose-task
# examples take none
EXAMPLES = {"fused_sac_state_sim": "state_sim", "fused_drq_sim": "drq_rlpd",
            "fused_peg_insert": None, "fused_cable_route": None, "vice_online": None}
# the evaluation keys of a chunk log beyond success and return, by their
# summary names
EXTRA_EVAL_KEYS = {"eval/classifier_success_rate": "eval_classifier_success",
                   "eval/vice_rate": "eval_vice_rate", "vice/bce_loss": "vice_bce"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def summarise(out: str, seed: int) -> dict:
    """One seed's curve from its chunk log and its printed SOLVED line."""
    rows = []
    for path in sorted(glob.glob(os.path.join(out, f"seed{seed}", "*.jsonl"))):
        with open(path) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    classifier = next(({k.split("/", 1)[1]: v for k, v in r.items() if k.startswith("classifier/")}
                       for r in rows if any(k.startswith("classifier/") for k in r)), None)
    rows = [r for r in rows if "env_steps" in r]
    evals = [{"env_steps": r["env_steps"], "eval_success": r["eval/success_rate"],
              "eval_return": r.get("eval/return_mean"),
              "train_success": r.get("train/success_rate"),
              "env_steps_per_s": r["env_steps_per_s"],
              **{name: r[k] for k, name in EXTRA_EVAL_KEYS.items() if k in r}}
             for r in rows if "eval/success_rate" in r]
    solved = None
    with open(os.path.join(out, f"seed{seed}.log")) as f:
        for line in f:
            found = re.search(r"SOLVED .* at (\d+) env steps", line)
            if found:
                solved = int(found.group(1))
    return {"seed": seed, "classifier": classifier, "evals": evals,
            "solved_at_env_steps": solved,
            "last_env_steps": rows[-1]["env_steps"] if rows else None,
            "env_steps_per_s": rows[-1]["env_steps_per_s"] if rows else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--example", choices=sorted(EXAMPLES), default="fused_sac_state_sim")
    p.add_argument("--preset", default=None)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--total_env_steps", type=int, default=200_000)
    p.add_argument("--success_stop", type=float, default=0.97)
    p.add_argument("--pixels", action="store_true", help="fused_peg_insert from pixels")
    args = p.parse_args(argv)
    preset = args.preset or EXAMPLES[args.example]

    def recipe(seed):
        if EXAMPLES[args.example] is None:  # a pose-task example, its recipe as it is
            return (["--seed", str(seed), "--total_steps", str(args.total_env_steps)]
                    + (["--pixels"] if args.pixels else []))
        return ["--rlpd", "--preset", preset, "--seed", str(seed),
                "--total_env_steps", str(args.total_env_steps)]

    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS_PER_SEED))
    procs, logs = {}, []
    t0 = time.time()
    try:
        for seed in args.seeds:
            log = open(os.path.join(args.out, f"seed{seed}.log"), "w")
            logs.append(log)
            procs[seed] = subprocess.Popen(
                [sys.executable, "-m", f"serl_tpu_torch.examples.{args.example}", *recipe(seed),
                 "--success_stop", str(args.success_stop),
                 "--log_dir", os.path.join(args.out, f"seed{seed}")],
                stdout=log, stderr=subprocess.STDOUT, env=env)
        codes = {seed: proc.wait() for seed, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    summary = {"card": card, "example": args.example, "preset": preset, "pixels": args.pixels,
               "wall_s": time.time() - t0, "exit_codes": codes,
               "seeds": [summarise(args.out, seed) for seed in args.seeds]}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if all(code == 0 for code in codes.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
