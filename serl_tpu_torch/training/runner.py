"""The host-side loop of a training run: chunks of loop iterations, logging,
periodic evaluation, the best evaluation's params, the solve rule, and
checkpoints with pause and resume.

Port of `serl_tpu/training/runner.py`: `run_fused` and
`eval_from_checkpoint`, over `training/checkpointing.py`.
"""

import os
import time
from typing import Callable, Optional

import numpy as np

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.training.checkpointing import CheckpointManager
from serl_tpu_torch.training.loop import evaluate
from serl_tpu_torch.utils.timer import Timer


def run_fused(env, agent, rb, config, init_fn, run_chunk, *, total_env_steps: int = 500_000,
              chunk_iters: int = 100, eval_period_chunks: int = 5, eval_episodes: int = 32,
              seed: int = 0, demo_state=None, logger: Optional[Logger] = None,
              checkpoint_dir: Optional[str] = None, checkpoint_period_chunks: int = 50,
              success_stop: Optional[float] = None, obs_fn: Optional[Callable] = None,
              log_fn: Optional[Callable] = None, pause_file: Optional[str] = None,
              resume: bool = False):
    """Run chunks of `chunk_iters` loop iterations until `total_env_steps`,
    logging each chunk (the JAX package's keys) and evaluating every
    `eval_period_chunks` chunks (`eval_episodes` argmax episodes, seed
    10_000 + chunk). With `success_stop`, the run stops once two evaluations
    in a row reach it. `log_fn(log, carry)` sees each chunk's log.

    With `checkpoint_dir`, the agent's params are saved there (one step
    directory each, by env steps) at each new best evaluation, every
    `checkpoint_period_chunks` chunks and at the end. The pause path (the
    reference PCB example's pause key, headless): once `pause_file` (default
    `<checkpoint_dir>/PAUSE`) exists after a chunk, the full loop carry is
    saved under `<checkpoint_dir>/pause`, the file removed, and the run
    returns; `resume=True` restores the newest pause checkpoint into the
    fresh carry and goes on, bit for bit as if never paused (the chunk
    count, evaluation seeds and best evaluation start anew, as in the JAX
    package).

    Returns (carry, best): `best` holds the best evaluation's "success",
    "steps" and "params", a detached copy of the agent's param groups (the
    optimizers update the live params in place)."""
    logger = logger or Logger(description="fused_run")
    ckpt = pause_ckpt = None
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        pause_ckpt = CheckpointManager(os.path.join(checkpoint_dir, "pause"))
        if pause_file is None:
            pause_file = os.path.join(checkpoint_dir, "PAUSE")
    elif pause_file is not None or resume:
        raise ValueError("pause_file and resume need checkpoint_dir")
    carry = init_fn(agent, seed, demo_state=demo_state)
    if resume:
        if pause_ckpt.latest_step() is None:
            raise FileNotFoundError(f"resume=True but no pause checkpoint under "
                                    f"{os.path.join(checkpoint_dir, 'pause')}")
        carry = pause_ckpt.restore(target=carry)
        print(f"resumed from pause checkpoint at step {carry.env_steps}", flush=True)
    timer = Timer()
    t0 = time.time()
    chunk = 0
    prev = (0.0, 0.0, 0)
    # sparse-reward policies oscillate between evals: keep the best params seen
    best = {"success": -1.0, "steps": 0, "params": None}
    solve_streak = 0
    while carry.env_steps < total_env_steps:
        with timer.context("run_chunk"):
            carry, metrics = run_chunk(carry, chunk_iters)
            m = {k: v.cpu().numpy() for k, v in metrics.items()}  # waits for the chunk
        chunk += 1
        steps = int(m["env_steps"][-1])
        eps = int(m["ep_count"][-1]) - prev[2]
        train_ret = (float(m["ret_sum"][-1]) - prev[0]) / max(1, eps)
        train_succ = (float(m["succ_sum"][-1]) - prev[1]) / max(1, eps)
        prev = (float(m["ret_sum"][-1]), float(m["succ_sum"][-1]), int(m["ep_count"][-1]))

        log = {
            "env_steps": steps,
            "env_steps_per_s": steps / (time.time() - t0),
            "train/episode_return": train_ret,
            "train/success_rate": train_succ,
            "train/critic_loss": float(m["critic_loss"][-1]),
            "train/actor_loss": float(m["actor_loss"][-1]),
            "train/temperature": float(m["temperature"][-1]),
            "train/entropy": float(m["entropy"][-1]),
            "buffer_size": int(m["buffer_size"][-1]),
            "timer": timer.get_average_times(),
        }
        if chunk % eval_period_chunks == 0:
            ev = evaluate(env, carry.agent, 10_000 + chunk, num_episodes=eval_episodes,
                          obs_fn=obs_fn, pixel_keys=rb.image_keys)
            log.update(ev)
            print(f"steps {steps} ({log['env_steps_per_s']:.0f}/s) "
                  f"train_succ {train_succ:.2f} eval_succ {ev['eval/success_rate']:.2f} "
                  f"eval_ret {ev['eval/return_mean']:.1f}", flush=True)
            if ev["eval/success_rate"] > best["success"]:
                best = {
                    "success": ev["eval/success_rate"],
                    "steps": steps,
                    "params": {g: [p.detach().clone() for p in ps]
                               for g, ps in carry.agent.state.params.items()},
                }
                if ckpt:
                    ckpt.save(steps, {"agent_params": best["params"]})
            # solved: 2 consecutive evals at or above the bar (one 16-32
            # episode eval is within noise of a ~0.7 policy)
            if success_stop is not None and ev["eval/success_rate"] >= success_stop:
                solve_streak += 1
            else:
                solve_streak = 0
            if success_stop is not None and solve_streak >= 2:
                print(f"SOLVED (eval >= {success_stop} on 2 consecutive evals) "
                      f"at {steps} env steps ({time.time() - t0:.0f}s)", flush=True)
                logger.log(log, step=steps)
                break
        if log_fn:
            log_fn(log, carry)
        logger.log(log, step=steps)
        if pause_file and os.path.exists(pause_file):
            pause_ckpt.save(steps, carry, wait=True)
            os.remove(pause_file)
            print(f"PAUSED at {steps} env steps; full carry saved to "
                  f"{os.path.join(checkpoint_dir, 'pause')}", flush=True)
            logger.close()
            return carry, best
        if ckpt and chunk % checkpoint_period_chunks == 0:
            ckpt.save(steps, {"agent_params": carry.agent.state.params})
    if best["params"] is not None:
        print(f"BEST eval_succ {best['success']:.2f} at {best['steps']} env steps"
              + (" (checkpointed)" if ckpt else ""), flush=True)
    if ckpt:
        ckpt.save(carry.env_steps, {"agent_params": carry.agent.state.params})
        ckpt.close()
    logger.close()
    return carry, best


def eval_from_checkpoint(env, agent, rb, checkpoint_dir: str, *, step: Optional[int] = None,
                         num_episodes: int = 32, num_rounds: int = 1, seed: int = 0,
                         obs_fn: Optional[Callable] = None):
    """Checkpoint-eval mode (the reference's --eval_checkpoint_step): the
    agent's params restored in place from `run_fused`'s checkpoint `step`
    (default the latest), then `num_rounds` evaluations of `num_episodes`
    argmax episodes, round r seeded with seed + r. Returns (agent, mean
    success over the rounds)."""
    mngr = CheckpointManager(checkpoint_dir)
    if mngr.latest_step() is None:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    step = mngr.latest_step() if step is None else step
    mngr.restore(step, target={"agent_params": agent.state.params})
    print(f"evaluating checkpoint step {step} from {checkpoint_dir}", flush=True)
    agg = []
    for r in range(num_rounds):
        ev = evaluate(env, agent, seed + r, num_episodes=num_episodes, obs_fn=obs_fn,
                      pixel_keys=rb.image_keys)
        agg.append(ev["eval/success_rate"])
        print(f"round {r}: success {ev['eval/success_rate']:.2f} "
              f"return {ev['eval/return_mean']:.1f}", flush=True)
    print(f"mean success over {num_rounds} rounds: {float(np.mean(agg)):.3f}", flush=True)
    return agent, float(np.mean(agg))
