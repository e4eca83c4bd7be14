"""Async actor/learner DrQ on pixel PandaPickCube (the two-process mode).

Port of `examples/async_drq_sim.py` (reference
`examples/async_drq_sim/async_drq_sim.py`): an actor steps one pixel env
(the front and wrist cameras, K2) and pushes image transitions, uint8
frames staying uint8 on the wire; a learner trains DrQ (K3's crop inside
the update) on a host replay ring and broadcasts params every
`--publish_period` updates. With `--demo_path` each UTD minibatch mixes the
ring and a demo ring 50/50 (RLPD); the file is a pickle of transitions in
`_example_transition`'s layout (frames with the frame-stack axis,
(1, H, W, 3)), as a list of dicts or as stacked arrays
(`data/demos.py::save_demos`).

    python -m serl_tpu_torch.examples.async_drq_sim --learner [--demo_path demos.pkl]
    python -m serl_tpu_torch.examples.async_drq_sim --actor [--ip 127.0.0.1] [--device cpu]

The learner copies each host batch (batch x UTD rows, both cameras, obs and
next_obs: ~200 MB of uint8 at the defaults) to the card through pinned
buffers (`data/host_buffer.py::HostToDevice`) and reports the host sample,
the pinned staging and the copy's device time per update in its summary.
Everything else (devices, the params hot-swap, --diagnostics, the summary
lines) is as in `async_sac_state_sim.py`.
"""

import argparse
import time

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.data.host_buffer import (
    HostToDevice,
    ReplayBufferDataStore,
    map_tree,
    populate_data_store,
    tree_leaves,
)
from serl_tpu_torch.distributed.transport import TrainerServer
from serl_tpu_torch.envs.panda_pick import ACTION_DIM, PIXEL_STATE_DIM, PandaPickCubeEnv
from serl_tpu_torch.envs.wrappers import add_stack_axis, serl_obs
from serl_tpu_torch.examples.async_sac_state_sim import (
    Publisher,
    add_common_args,
    kernel_report,
    learner_summary,
    load_newest,
    make_actor_client,
    phase_rates,
    print_summary,
    random_actions,
    start_diagnostics,
    stats_callback,
    wait_for_data,
)
from serl_tpu_torch.training.config import WorkloadConfig
from serl_tpu_torch.training.launcher import make_drq_agent
from serl_tpu_torch.utils.timer import Timer

IMAGE_KEYS = ("front", "wrist")


def _pixel_obs(obs_d):
    """Env obs dict of N envs -> the SERL flat dict with the T = 1
    frame-stack axis, on the env's device: {"state": (N, 7), "<camera>":
    (N, 1, H, W, 3) uint8}."""
    return add_stack_axis(serl_obs(obs_d), IMAGE_KEYS)


def _host_obs(obs) -> dict:
    """One env's observation (row 0) as numpy; frames stay uint8."""
    return {k: v[0].cpu().numpy() for k, v in obs.items()}


def _example_transition(image_size: int) -> dict:
    img = np.zeros((1, image_size, image_size, 3), np.uint8)
    obs = {"state": np.zeros(PIXEL_STATE_DIM, np.float32), "front": img, "wrist": img}
    return {
        "observations": obs,
        "actions": np.zeros(ACTION_DIM, np.float32),
        "next_observations": obs,
        "rewards": np.float32(0),
        "masks": np.float32(0),
        "dones": np.float32(0),
    }


def pixel_transition(obs_np: dict, action: torch.Tensor, next_obs: dict, reward: torch.Tensor,
                     done: torch.Tensor):
    """(the transition of one env's step as numpy, next_obs as numpy)."""
    row = torch.cat([action, reward[:, None], done[:, None]], 1)[0].cpu().numpy()
    next_np = _host_obs(next_obs)
    d = row[-1]
    return {
        "observations": obs_np,
        "actions": row[:ACTION_DIM],
        "next_observations": next_np,
        "rewards": np.float32(row[-2]),
        "masks": np.float32(1.0 - d),
        "dones": np.float32(d),
    }, next_np


def make_agent(cfg: WorkloadConfig, device):
    sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
              **{k: torch.zeros((1, 1, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8)
                 for k in IMAGE_KEYS}}
    return make_drq_agent(cfg.seed, sample, torch.zeros((1, ACTION_DIM)), image_keys=IMAGE_KEYS,
                          encoder_type=cfg.encoder_type, device=device)


def actor_loop(cfg: WorkloadConfig, args):
    device = resolve_device(args.device)
    env = PandaPickCubeEnv(image_obs=True, render_size=cfg.image_size, device=device)
    agent = make_agent(cfg, device)
    data_store, client, latest = make_actor_client(cfg, 1000)
    g = torch.Generator(device=device).manual_seed(cfg.seed)

    state, obs_d = env.reset(1, g)
    obs = _pixel_obs(obs_d)
    obs_np = _host_obs(obs)
    timer = Timer()
    ep_ret, ep_count, succ_count = 0.0, 0, 0
    t0 = t_policy = time.perf_counter()
    for step_i in range(args.max_steps):
        if step_i == cfg.random_steps:
            t_policy = time.perf_counter()
        load_newest(latest, agent, args, timer)
        with timer.context("sample_actions"):
            if step_i < cfg.random_steps:
                action = random_actions(1, g, device)
            else:
                action = agent.sample_actions(obs, generator=g)
        with timer.context("step_env"):
            state, next_obs_d, reward, done, info = env.step(state, action)
            obs = _pixel_obs(next_obs_d)
        with timer.context("to_host"):  # waits for the step's kernels
            tr, obs_np_next = pixel_transition(obs_np, action, obs, reward, done)
        data_store.insert(tr)
        obs_np = obs_np_next
        ep_ret += float(tr["rewards"])
        if tr["dones"] > 0.5:
            ep_count += 1
            succ_count += int(float(info["success"][0]) > 0.5)
            state, obs_d = env.reset(1, g)
            obs = _pixel_obs(obs_d)
            obs_np = _host_obs(obs)
            if ep_count % 5 == 0:
                client.request("send-stats", {
                    "episode_return": ep_ret, "episodes": ep_count,
                    "success_rate": succ_count / max(ep_count, 1),
                    "timer": timer.get_average_times(reset=False)})
            ep_ret = 0.0
        if step_i % cfg.steps_per_update == 0:
            client.update()
        if step_i % 1000 == 0:
            print(f"actor step {step_i}, episodes {ep_count}", flush=True)
    t_end = time.perf_counter()
    seconds, random_steps = t_end - t0, min(cfg.random_steps, args.max_steps)
    client.update()
    client.stop()
    print_summary("actor", {
        "steps": args.max_steps, "random_steps": random_steps,
        "env_steps_s": args.max_steps / seconds, "seconds": seconds,
        **phase_rates(t0, t_policy, t_end, random_steps, args.max_steps), "episodes": ep_count,
        "successes": succ_count, "versions_received": latest.received,
        "versions_loaded": latest.loaded, "times": timer.get_average_times(),
        **kernel_report(args)})


def _sample_rlpd(replay, demo, batch_size: int, utd_ratio: int, rng: np.random.Generator):
    """One learner batch with each UTD minibatch mixed 50/50 online/demo
    (reference async_drq_sim.py:269-292 concat_batches): update_high_utd
    splits the leading axis into (utd, batch), so interleaving per
    minibatch here gives the reference's per-step concatenation."""
    half = batch_size // 2
    online = replay.sample(half * utd_ratio, rng)
    dem = demo.sample(half * utd_ratio, rng)

    def mix(a, b):
        a = a.reshape((utd_ratio, half) + a.shape[1:])
        b = b.reshape((utd_ratio, half) + b.shape[1:])
        out = np.concatenate([a, b], axis=1)
        return out.reshape((utd_ratio * 2 * half,) + out.shape[2:])

    return map_tree(mix, online, dem)


def learner_loop(cfg: WorkloadConfig, args):
    device = resolve_device(args.device)
    agent = make_agent(cfg, device)
    example = _example_transition(cfg.image_size)
    replay = ReplayBufferDataStore(example, capacity=cfg.buffer_capacity)
    demo = None
    if args.demo_path:
        demo = ReplayBufferDataStore(example, capacity=cfg.buffer_capacity)
        print(f"loaded {populate_data_store(demo, args.demo_path)} demo transitions", flush=True)
    server = TrainerServer(cfg.trainer_config(), request_callback=stats_callback)
    server.register_data_store("actor_env", replay)
    server.start(threaded=True)
    ring_at_start = wait_for_data(replay, cfg.training_starts)

    publish = Publisher(server, args.diagnostics)
    publish(agent)
    rng = np.random.default_rng(cfg.seed)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    to_device = HostToDevice(device)
    timer = Timer()
    losses, h2d_ms = [], 0.0
    t0 = time.perf_counter()
    for update_step in range(args.max_steps):
        with timer.context("sample_replay_buffer"):
            if demo is not None:
                host = _sample_rlpd(replay, demo, cfg.batch_size, cfg.utd_ratio, rng)
            else:
                host = replay.sample(cfg.batch_size * cfg.utd_ratio, rng)
        with timer.context("stage"):  # the pinned copy on the host; the device copy queued
            batch = to_device(host)
        with timer.context("train"):
            agent, info = agent.update_high_utd(batch, utd_ratio=cfg.utd_ratio, generator=g)
            losses.append(float(info["critic"]["critic_loss"]))  # waits for the update
        if device.type == "cuda":
            h2d_ms += to_device.last_copy_ms()
        if update_step % cfg.publish_period == 0:
            publish(agent)
        if update_step % args.log_period == 0:
            print(f"update {update_step} closs {losses[-1]:.4f} buffer {len(replay)} "
                  f"times {timer.get_average_times(reset=False)}", flush=True)
    seconds = time.perf_counter() - t0
    server.stop()
    summary = learner_summary(cfg, args, seconds, losses, replay, ring_at_start, publish, timer)
    summary["h2d_ms"] = h2d_ms / args.max_steps if device.type == "cuda" else None
    summary["batch_bytes"] = sum(a.nbytes for a in tree_leaves(host))
    print_summary("learner", summary)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--encoder_type", default="small",
                   help="small | resnet | resnet50 | resnet-pretrained")
    p.add_argument("--critic_actor_ratio", type=int, default=4)
    p.add_argument("--publish_period", type=int, default=30)
    p.add_argument("--log_period", type=int, default=50)
    p.add_argument("--demo_path", default=None)
    p.add_argument("--replay_capacity", type=int, default=25_000)
    args = p.parse_args(argv)
    if args.learner == args.actor:
        raise SystemExit("pass exactly one of --learner/--actor")
    cfg = WorkloadConfig.preset(
        "drq_rlpd" if args.demo_path else "drq_sim", ip=args.ip, port=args.port, seed=args.seed,
        image_size=args.image_size, encoder_type=args.encoder_type, batch_size=args.batch_size,
        utd_ratio=args.critic_actor_ratio, training_starts=args.training_starts,
        random_steps=args.random_steps, steps_per_update=args.steps_per_update,
        publish_period=args.publish_period, buffer_capacity=args.replay_capacity,
        total_env_steps=args.max_steps)
    start_diagnostics(args)
    (learner_loop if args.learner else actor_loop)(cfg, args)


if __name__ == "__main__":
    main()
