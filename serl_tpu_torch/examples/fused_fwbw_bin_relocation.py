"""Forward/backward bin relocation: chained, reset-free, two policies (E6).

Port of `examples/fused_fwbw_bin_relocation.py`, with its flags and
defaults. A batch of `ChainedBinEnv` envs (16 per task: 32) runs under one
loop; each env's task flips at success, its transitions go to the ring of
the task that owned them (`RoutedReplayBuffer`, 200,000 rows from states,
20,000 uint8 rows from pixels), and both agents (10 critics subsampled to
2, batch 256 x UTD 4, one update_high_utd an iteration each) train every
iteration on their rings mixed 50/50 with routed demo rings: 16 streams of
the relocation expert collected in a ground-truth chained env
(`collect_chained_demos`, --demo_steps steps a stream).

`--classifier_reward` (the reference's E6 default) drives reward,
termination and the switch by two per-task success classifiers on the
front camera (`train_fwbw_classifiers`: frames of 16 chained envs x 150
steps of the noisy expert at noise 0.05, 0.2, 0.4 and 0.8, labelled by the
ground truth; --classifier_epochs steps of 64 + 64 frames, half of each
side from the boundary-hard frames, cropped by K3; the false-positive and
false-negative rates per threshold printed), at --classifier_threshold.
`--pixels` trains DrQ from both cameras (small encoder); `--dense` the
reach / lift / carry shaping.

Every --eval_period env steps `evaluate_chained_env` runs --eval_episodes
round trips through a ground-truth chained env (the arm resets at the
switch, the cube stays); the run is solved at two evaluations in a row with
round trip >= --solve_threshold (alias --success_stop). At the end, FINAL
and the best snapshot's evaluation on fresh seeds, 64 episodes each. The
docstring recipe of the JAX example (state FINAL round trip 0.64):

    python -m serl_tpu_torch.examples.fused_fwbw_bin_relocation \\
        --bc_weight 0.3 --discount 0.98 --intervention_mode rescue \\
        --intervention_prob 0.02 --intervention_decay_steps 1500000 \\
        --intervention_min_prob 0.008 --fresh_reset_prob 0.1 \\
        --demo_steps 600 --total_steps 3000000

Lines go to --log (default stdout) and each evaluation to --log_dir as a
JSON line ("eval/success_rate" is the round trip). Runs on the CUDA card
unless `--device cpu`.
"""

import argparse
import sys
import time

import numpy as np
import torch

from serl_tpu_torch.common.logger import Logger
from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer
from serl_tpu_torch.envs.chained_bin import CLS_KEY, ChainedBinEnv
from serl_tpu_torch.envs.rendering import render_cameras
from serl_tpu_torch.envs.tasks import (
    BIN_HALF,
    BW_BIN,
    FW_BIN,
    PIXEL_STATE_DIM,
    STATE_OBS_DIM,
    bin_success,
)
from serl_tpu_torch.networks.classifier import (
    classifier_fn,
    classifier_train_step,
    create_classifier,
)
from serl_tpu_torch.training.fwbw import (
    FwBwConfig,
    chained_expert_action,
    collect_chained_demos,
    evaluate_chained_env,
    make_chained_loop,
)
from serl_tpu_torch.training.launcher import make_drq_agent, make_sac_agent
from serl_tpu_torch.vision.augmentations import crop_images, crop_offsets

ACT_DIM = 7
IMAGE_KEYS = ("front", "wrist")
CLASSIFIER_STREAMS, CLASSIFIER_STEPS = 16, 150
CLASSIFIER_NOISE = (0.05, 0.2, 0.4, 0.8)
CLASSIFIER_HALF = 64  # positives and negatives per classifier step
FP_THRESHOLDS = (0.5, 0.75, 0.85, 0.95)
FINAL_EPISODES = 64


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--envs_per_task", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--utd_ratio", type=int, default=4)
    p.add_argument("--training_starts", type=int, default=2000)
    p.add_argument("--random_steps", type=int, default=2000)
    p.add_argument("--updates_per_iter", type=int, default=1)
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--intervention_prob", type=float, default=0.5)
    p.add_argument("--intervention_mode", default="episode",
                   choices=["step", "episode", "rescue"])
    p.add_argument("--intervention_decay_steps", type=int, default=300_000)
    p.add_argument("--intervention_min_prob", type=float, default=0.05)
    p.add_argument("--discount", type=float, default=0.98)
    p.add_argument("--bc_weight", type=float, default=0.3)
    p.add_argument("--lr_decay", action="store_true",
                   help="cosine learning-rate decay over the run")
    p.add_argument("--demo_streams", type=int, default=16)
    p.add_argument("--demo_steps", type=int, default=500,
                   help="chained-expert steps per demo stream (0 = no demos)")
    p.add_argument("--dense", action="store_true",
                   help="reach / lift / carry shaping instead of the sparse reward")
    p.add_argument("--fresh_reset_prob", type=float, default=0.05)
    p.add_argument("--classifier_reward", action="store_true",
                   help="per-task success classifiers drive reward, termination and the switch")
    p.add_argument("--classifier_epochs", type=int, default=800)
    p.add_argument("--classifier_threshold", type=float, default=0.85)
    p.add_argument("--pixels", action="store_true")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--total_steps", type=int, default=2_500_000)
    p.add_argument("--eval_period", type=int, default=16000)
    p.add_argument("--solve_threshold", "--success_stop", type=float, default=0.8,
                   dest="solve_threshold")
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def classifier_frames(args, device, streams=CLASSIFIER_STREAMS, steps=CLASSIFIER_STEPS):
    """Front frames (M, 1, H, W, 3) uint8 of `streams` chained envs (fresh
    reset prob 0.1) over `steps` steps of the expert plus Gaussian noise at
    each level of CLASSIFIER_NOISE, with each frame's cube position (M, 3)
    and its ground-truth labels, forward and backward (M,)."""
    env = ChainedBinEnv(dense_shaping=False, image_obs=False, fresh_reset_prob=0.1,
                        device=device)
    frames, cubes = [], []
    for i, noise in enumerate(CLASSIFIER_NOISE):
        g = torch.Generator(device=env.device).manual_seed(args.seed + 7000 + i)
        states, _ = env.reset(streams, g)
        for _ in range(steps):
            a = chained_expert_action(env, states)
            a = torch.clamp(a + noise * torch.randn(a.shape, generator=g, device=env.device),
                            -1.0, 1.0)
            states, _, _, _, _ = env.step_auto_reset(states, a, generator=g, final_obs=False)
            frames.append(render_cameras(states.env.physics, args.image_size)[0])
            cubes.append(states.env.physics.cube_pos)
    frames = torch.cat(frames)[:, None]
    cubes = torch.cat(cubes)
    fw_bin = torch.tensor(FW_BIN, device=env.device)
    bw_bin = torch.tensor(BW_BIN, device=env.device)
    return frames, cubes, bin_success(cubes, fw_bin), bin_success(cubes, bw_bin)


def train_fwbw_classifiers(args, out, device, data=None, epochs=None):
    """Per-task success classifiers on the front camera (the reference's
    fwbw train_reward_classifier). Returns ((fw_fn, bw_fn), info): each fn
    maps {"front": (N, 1, H, W, 3) uint8} to (N,) logits; info per task
    holds the data counts, the last step's loss and accuracy and the
    (false-positive, false-negative) rates per threshold. `data` skips the
    frames' collection; `epochs` overrides --classifier_epochs."""
    frames, cubes, lab_fw, lab_bw = data if data is not None else classifier_frames(args, device)
    device = frames.device
    print(f"classifier data: {frames.shape[0]} frames (fw pos {float(lab_fw.mean()):.2f}, "
          f"bw pos {float(lab_bw.mean()):.2f})", file=out, flush=True)
    epochs = args.classifier_epochs if epochs is None else epochs
    n_half = CLASSIFIER_HALF
    labels_step = torch.cat([torch.ones(n_half, device=device), torch.zeros(n_half, device=device)])
    fns, info = [], {}
    for task, (name, labels) in enumerate((("fw", lab_fw), ("bw", lab_bw))):
        # boundary-hard frames: the cube near the target bin's rim or lifted,
        # where a false positive ends episodes and the policy farms it
        tgt = torch.tensor(FW_BIN if name == "fw" else BW_BIN, device=device)
        edge = ((cubes[:, :2] - tgt).abs().amax(-1) - BIN_HALF).abs()
        hard = (edge < 0.035) | (cubes[:, 2] > 0.045)
        pos_mask = labels > 0.5
        pos, neg = frames[pos_mask], frames[~pos_mask]
        pos_hard = torch.nonzero(hard[pos_mask]).reshape(-1)
        neg_hard = torch.nonzero(hard[~pos_mask]).reshape(-1)
        print(f"{name}: {pos.shape[0]} pos ({pos_hard.numel()} hard) / {neg.shape[0]} neg "
              f"({neg_hard.numel()} hard)", file=out, flush=True)
        state = create_classifier({CLS_KEY: pos[:1]}, (CLS_KEY,), encoder_type="small",
                                  generator=torch.Generator().manual_seed(args.seed + task),
                                  device=device)
        g = torch.Generator(device=device).manual_seed(args.seed + 17)
        step_info = {}
        for _ in range(epochs):
            pi = torch.randint(0, pos.shape[0], (n_half,), generator=g, device=device)
            ni = torch.randint(0, neg.shape[0], (n_half,), generator=g, device=device)
            # half of each side from the boundary-hard pools
            if pos_hard.numel() > 0:
                sel = torch.randint(0, pos_hard.numel(), (n_half // 2,), generator=g, device=device)
                pi[: n_half // 2] = pos_hard[sel]
            if neg_hard.numel() > 0:
                sel = torch.randint(0, neg_hard.numel(), (n_half // 2,), generator=g, device=device)
                ni[: n_half // 2] = neg_hard[sel]
            px = torch.cat([pos[pi], neg[ni]], 0)
            px = crop_images([px], [crop_offsets(2 * n_half, 4, g, device)], padding=4,
                             num_batch_dims=2)[0]
            state, step_info = classifier_train_step(
                state, {"observations": {CLS_KEY: px}, "labels": labels_step}, generator=g)
        fn = classifier_fn(state)

        @torch.no_grad()
        def probs(x, fn=fn):
            """sigmoid of the logits of x's frames, in blocks of the train
            step's 2 x CLASSIFIER_HALF rows (the last block padded)."""
            block, out = 2 * n_half, []
            for i in range(0, x.shape[0], block):
                part = x[i:i + block]
                pad = block - part.shape[0]
                if pad:
                    part = torch.cat([part, part[:1].expand((pad,) + part.shape[1:])])
                out.append(torch.sigmoid(fn({CLS_KEY: part}))[: block - pad])
            return torch.cat(out) if out else torch.zeros(0, device=x.device)

        pos_p, neg_p = probs(pos), probs(neg)
        rates = {t: (float((neg_p >= t).float().mean()) if neg_p.numel() else 0.0,
                     float((pos_p < t).float().mean()) if pos_p.numel() else 0.0)
                 for t in FP_THRESHOLDS}
        loss = float(step_info["loss"]) if step_info else float("nan")
        acc = float(step_info["accuracy"]) if step_info else float("nan")
        print(f"{name} classifier: final loss {loss:.4f} acc {acc:.3f} ({pos.shape[0]} pos / "
              f"{neg.shape[0]} neg); FP/FN per threshold: "
              + " ".join(f"{t}:{fp:.3f}/{fn_:.3f}" for t, (fp, fn_) in rates.items()),
              file=out, flush=True)
        info[name] = {"positives": int(pos.shape[0]), "negatives": int(neg.shape[0]),
                      "loss": loss, "accuracy": acc, "fp_fn": rates, "state": state}
        fns.append(fn)
    return tuple(fns), info


def config_from(args) -> FwBwConfig:
    n = args.envs_per_task * 2
    return FwBwConfig(
        envs_per_task=args.envs_per_task,
        batch_size=args.batch_size,
        utd_ratio=args.utd_ratio,
        updates_per_iter=args.updates_per_iter,
        training_starts=args.training_starts,
        random_steps=args.random_steps,
        buffer_capacity=((20_000 if args.pixels else 200_000) // n) * n,
        demo_fraction=0.5 if args.demo_steps > 0 else 0.0,
        intervention_prob=args.intervention_prob,
        intervention_mode=args.intervention_mode,
        intervention_decay_steps=args.intervention_decay_steps,
        intervention_min_prob=args.intervention_min_prob,
    )


def make_buffer(args, capacity: int, device) -> RoutedReplayBuffer:
    if not args.pixels:
        example = {"observations": torch.zeros((STATE_OBS_DIM,)),
                   "actions": torch.zeros((ACT_DIM,)),
                   "next_observations": torch.zeros((STATE_OBS_DIM,)),
                   "rewards": torch.zeros(()), "masks": torch.zeros(()), "dones": torch.zeros(())}
        return RoutedReplayBuffer(example, capacity=capacity, device=device)
    img = torch.zeros((args.image_size, args.image_size, 3), dtype=torch.uint8)
    example = {"observations": {"state": torch.zeros((PIXEL_STATE_DIM,)), "front": img,
                                "wrist": img},
               "actions": torch.zeros((ACT_DIM,)), "rewards": torch.zeros(()),
               "masks": torch.zeros(()), "dones": torch.zeros(())}
    return RoutedReplayBuffer(example, capacity=capacity, store_next_obs=False,
                              image_keys=IMAGE_KEYS, num_stack=1, device=device)


def make_agents(args, device):
    """(fw_agent, bw_agent), seeded args.seed and args.seed + 1."""
    opt_kwargs = {}
    if args.lr_decay:
        iters = args.total_steps // (2 * args.envs_per_task)
        critic_steps = iters * args.updates_per_iter * args.utd_ratio
        actor_steps = iters * args.updates_per_iter
        opt_kwargs = dict(
            actor_optimizer_kwargs={"learning_rate": 3e-4, "warmup_steps": 2000,
                                    "cosine_decay_steps": actor_steps},
            critic_optimizer_kwargs={"learning_rate": 3e-4, "warmup_steps": 2000,
                                     "cosine_decay_steps": critic_steps})

    def one(seed):
        if not args.pixels:
            return make_sac_agent(seed, obs_dim=STATE_OBS_DIM, action_dim=ACT_DIM,
                                  discount=args.discount, bc_regularization=args.bc_weight,
                                  device=device, **opt_kwargs)
        size = args.image_size
        sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
                  **{k: torch.zeros((1, 1, size, size, 3), dtype=torch.uint8)
                     for k in IMAGE_KEYS}}
        return make_drq_agent(seed, sample, torch.zeros((1, ACT_DIM)), image_keys=IMAGE_KEYS,
                              encoder_type="small", discount=args.discount,
                              bc_regularization=args.bc_weight, device=device, **opt_kwargs)

    return one(args.seed), one(args.seed + 1)


def build(args, out=sys.stdout, classifiers=None):
    """(env, eval_env, rb, config, fw_agent, bw_agent, init_fn, run_chunk,
    demos, info): the classifiers with --classifier_reward (trained here
    unless `classifiers`, (fw_fn, bw_fn), are given), the training env, the
    ground-truth evaluation env, the online ring spec, both agents, the
    loop and the demo rings (fw_demo, bw_demo, demo_rb); info holds the
    demo statistics and the classifiers' report."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card: pass --device cpu to run on the CPU")
    info = {}
    if args.classifier_reward and classifiers is None:
        classifiers, info["classifiers"] = train_fwbw_classifiers(args, out, device)
    env = ChainedBinEnv(dense_shaping=args.dense, image_obs=args.pixels,
                        render_size=args.image_size, fresh_reset_prob=args.fresh_reset_prob,
                        classifier_fns=classifiers if args.classifier_reward else None,
                        classifier_threshold=args.classifier_threshold, device=device)
    config = config_from(args)
    rb = make_buffer(args, config.buffer_capacity, env.device)
    fw_agent, bw_agent = make_agents(args, env.device)
    demos = (None, None, None)
    if args.demo_steps > 0:
        demo_rb = make_buffer(args, args.demo_streams * args.demo_steps, env.device)
        # demos from a ground-truth chained env: a classifier's false
        # positives would cut expert episodes short and mislabel them
        demo_env = ChainedBinEnv(dense_shaping=args.dense, image_obs=args.pixels,
                                 render_size=args.image_size,
                                 fresh_reset_prob=args.fresh_reset_prob, device=env.device)
        fw_demo, bw_demo, stats = collect_chained_demos(
            demo_env, demo_rb, args.demo_streams, args.demo_steps, args.seed + 1000,
            pixel_obs=args.pixels)
        print(f"chained demos: {stats}", file=out, flush=True)
        info["demos"] = stats
        demos = (fw_demo, bw_demo, demo_rb)
    eval_env = ChainedBinEnv(dense_shaping=args.dense, image_obs=args.pixels,
                             render_size=args.image_size, fresh_reset_prob=0.0,
                             device=env.device)
    init_fn, run_chunk = make_chained_loop(env, rb, config)
    return env, eval_env, rb, config, fw_agent, bw_agent, init_fn, run_chunk, demos, info


def eval_line(ev) -> str:
    return (f"eval_fw {ev['eval/fw_success']:.2f} eval_bw {ev['eval/bw_success']:.2f} "
            f"eval_bw|fw {ev['eval/bw_success_given_fw']:.2f} "
            f"round_trip {ev['eval/round_trip_success']:.2f}")


def _snapshot(agent):
    return {k: v.detach().clone() for k, v in agent.state_dict().items()}


def main(argv=None):
    args = parser().parse_args(argv)
    out = open(args.log, "a") if args.log else sys.stdout
    (env, eval_env, rb, config, fw_agent, bw_agent, init_fn, run_chunk, demos,
     info) = build(args, out)
    logger = Logger(description="fused_fwbw_bin_relocation", output_dir=args.log_dir,
                    variant=vars(args))
    for name, c in info.get("classifiers", {}).items():
        logger.log({f"classifier/{name}_{k}": v for k, v in c.items()
                    if k in ("positives", "negatives", "loss", "accuracy")}, step=0)
    n = config.envs_per_task * 2
    fw_demo, bw_demo, demo_rb = demos
    carry = init_fn(fw_agent, bw_agent, args.seed, fw_demo=fw_demo, bw_demo=bw_demo,
                    demo_rb=demo_rb)
    chunk = max(args.eval_period // n, 1)
    pixel_keys = IMAGE_KEYS if args.pixels else ()
    t0 = time.time()
    prev = {k: np.zeros(2) for k in ("ep", "ret", "gt")}
    best = {"rt": -1.0, "pair": None, "step": 0}
    consecutive = 0
    while carry.env_steps < args.total_steps:
        carry, m = run_chunk(carry, chunk)
        steps = carry.env_steps
        last = {k: m[k][-1].cpu().numpy().astype(float) for k in ("ep_count", "ret_sum",
                                                                    "succ_gt_sum")}
        d_ep = np.maximum(last["ep_count"] - prev["ep"], 1)
        rate = steps / (time.time() - t0)
        line = f"steps {steps} ({rate:.0f}/s)"
        train = {}
        for t, name in enumerate(("fw", "bw")):
            train[name] = (last["succ_gt_sum"][t] - prev["gt"][t]) / d_ep[t]
            line += (f" {name}[succ {train[name]:.2f}"
                     f" ret {(last['ret_sum'][t] - prev['ret'][t]) / d_ep[t]:.1f}]")
        line += f" switches {int(m['switch_sum'][-1])}"
        prev = {"ep": last["ep_count"], "ret": last["ret_sum"], "gt": last["succ_gt_sum"]}
        ev = evaluate_chained_env(eval_env, carry.fw_agent, carry.bw_agent, steps,
                                  num_episodes=args.eval_episodes, pixel_keys=pixel_keys)
        print(f"{line} {eval_line(ev)}", file=out, flush=True)
        rt = ev["eval/round_trip_success"]
        logger.log({"env_steps": steps, "env_steps_per_s": rate,
                    "eval/success_rate": rt, **ev,
                    "train/fw_success_rate": train["fw"], "train/bw_success_rate": train["bw"],
                    "fw/critic_loss": float(m["fw/critic_loss"][-1]),
                    "bw/critic_loss": float(m["bw/critic_loss"][-1])}, step=steps)
        if rt > best["rt"]:
            best = {"rt": rt, "pair": (_snapshot(carry.fw_agent), _snapshot(carry.bw_agent)),
                    "step": steps}
        # solved: two evaluations in a row at the threshold
        consecutive = consecutive + 1 if rt >= args.solve_threshold else 0
        if consecutive >= 2:
            print(f"SOLVED (round-trip >= {args.solve_threshold} on 2 consecutive evals) at "
                  f"{steps} env steps ({time.time() - t0:.0f}s)", file=out, flush=True)
            break

    # fresh seeds, 64 episodes: the final pair and the best snapshot
    final = evaluate_chained_env(eval_env, carry.fw_agent, carry.bw_agent, 999331,
                                 num_episodes=FINAL_EPISODES, pixel_keys=pixel_keys)
    print(f"FINAL (fresh {FINAL_EPISODES} episodes): {eval_line(final)}", file=out, flush=True)
    logger.log({f"final/{k.split('/', 1)[1]}": v for k, v in final.items()}, step=carry.env_steps)
    if best["pair"] is not None:
        live = (_snapshot(carry.fw_agent), _snapshot(carry.bw_agent))
        carry.fw_agent.load_state_dict(best["pair"][0])
        carry.bw_agent.load_state_dict(best["pair"][1])
        b = evaluate_chained_env(eval_env, carry.fw_agent, carry.bw_agent, 999333,
                                 num_episodes=FINAL_EPISODES, pixel_keys=pixel_keys)
        carry.fw_agent.load_state_dict(live[0])
        carry.bw_agent.load_state_dict(live[1])
        print(f"BEST-SNAPSHOT (step {best['step']}, fresh {FINAL_EPISODES} episodes): "
              f"round_trip {b['eval/round_trip_success']:.2f}", file=out, flush=True)
        logger.log({"best/step": best["step"],
                    "best/round_trip_success": b["eval/round_trip_success"]},
                   step=carry.env_steps)
    logger.close()
    return carry


if __name__ == "__main__":
    main()
