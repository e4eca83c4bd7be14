"""Async actor/learner SAC on PandaPickCube (the two-process mode).

Port of `examples/async_sac_state_sim.py` (reference
`examples/async_sac_state_sim/async_sac_state_sim.py`): an actor process
steps one env and pushes transitions, a learner process trains SAC on a host
replay ring and broadcasts params, over the native C++ transport
(`distributed/transport.py`). The fused single-program mode
(`fused_sac_state_sim.py`) is the alternative on one host; this mode is for
an actor on another host, such as a robot's workstation.

    python -m serl_tpu_torch.examples.async_sac_state_sim --learner
    python -m serl_tpu_torch.examples.async_sac_state_sim --actor [--ip 127.0.0.1] \\
        [--device cpu]

Both processes run on the CUDA card unless `--device cpu` (a CUDA request
without CUDA raises); two processes can share one card. The learner
publishes `utils/jax_params.py::to_jax_layout(agent)`, the nested dict of
numpy arrays that the JAX learner publishes as `agent.state.params`. The
poll thread of the actor's client only stores the newest tree; the actor
loads it into its agent at the top of an iteration, so each step acts with
one whole version (loading in place from the poll thread would tear the
policy between two versions). `--diagnostics` prints the digest of every
published and every loaded version and, at the end, each kernel's launches
in this process and K5's shapes. Each process ends with one
`actor summary {...}` / `learner summary {...}` JSON line.
"""

import argparse
import json
import math
import threading
import time

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.data.host_buffer import ReplayBufferDataStore
from serl_tpu_torch.distributed.serialization import digest
from serl_tpu_torch.distributed.transport import QueuedDataStore, TrainerClient, TrainerServer
from serl_tpu_torch.envs.panda_pick import ACTION_DIM, STATE_OBS_DIM, PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.training.config import WorkloadConfig
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils.jax_params import load_sac_params, to_jax_layout
from serl_tpu_torch.utils.timer import Timer


def example_transition() -> dict:
    return {
        "observations": np.zeros(STATE_OBS_DIM, np.float32),
        "actions": np.zeros(ACTION_DIM, np.float32),
        "next_observations": np.zeros(STATE_OBS_DIM, np.float32),
        "rewards": np.float32(0),
        "masks": np.float32(0),
        "dones": np.float32(0),
    }


def transition(obs: np.ndarray, action: torch.Tensor, next_obs: torch.Tensor,
               reward: torch.Tensor, done: torch.Tensor):
    """(the transition of one env's step as numpy, next_obs as numpy): the
    step's (1, ...) tensors come to the host in one copy; `obs` is already
    there (the previous step's next_obs)."""
    row = torch.cat([action, next_obs, reward[:, None], done[:, None]], 1)[0].cpu().numpy()
    next_np = row[ACTION_DIM: ACTION_DIM + STATE_OBS_DIM]
    d = row[-1]
    return {
        "observations": obs,
        "actions": row[:ACTION_DIM],
        "next_observations": next_np,
        "rewards": np.float32(row[-2]),
        "masks": np.float32(1.0 - d),
        "dones": np.float32(d),
    }, next_np


def random_actions(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.rand((n, ACTION_DIM), generator=generator, device=device) * 2.0 - 1.0


class LatestParams:
    """The newest published param tree. The client's poll thread only
    stores it (`put`); the actor's main thread loads it into its agent at
    the top of an iteration (`load_into`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tree = None
        self.received = 0
        self.loaded = 0

    def put(self, tree):
        with self._lock:
            self._tree = tree
            self.received += 1

    def load_into(self, agent) -> bool:
        with self._lock:
            tree, self._tree = self._tree, None
        if tree is None:
            return False
        load_sac_params(agent, tree)
        self.loaded += 1
        return True


def kernel_counters() -> dict:
    """Each kernel's launches in this process, by wrapper."""
    from serl_tpu_torch.data import replay_buffer
    from serl_tpu_torch.envs import rendering
    from serl_tpu_torch.envs.physics import engine
    from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
    from serl_tpu_torch.vision import augmentations

    return {"control_step": engine.control_step.launches,
            "render": rendering.render_cameras.launches,
            "random_crop": augmentations.crop_images.launches,
            "replay_gather": replay_buffer.gather_batch_aligned.launches,
            "dense_layer_norm_tanh_fwd": k5.dense_layer_norm_tanh_forward.launches,
            "dense_layer_norm_tanh_bwd": k5.dense_layer_norm_tanh_backward.launches}


def start_diagnostics(args) -> None:
    """With --diagnostics, log K5's shapes from here on."""
    if args.diagnostics:
        from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

        k5.shape_log = set()


def kernel_report(args) -> dict:
    """The launches of every kernel in this process, and with --diagnostics
    the (form, E, M, K, D[, weight grads, dx]) K5 ran at."""
    out = {"launches": kernel_counters()}
    if args.diagnostics:
        from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

        out["k5_shapes"] = sorted(list(s) for s in k5.shape_log)
    return out


def phase_rates(t0, t_policy, t_end, random_steps: int, steps: int) -> dict:
    """The actor's env-steps/s over its random steps and over its policy
    steps (host clock)."""
    policy = steps - random_steps
    return {"env_steps_s_random": random_steps / ((t_policy if policy else t_end) - t0)
            if random_steps else None,
            "env_steps_s_policy": policy / (t_end - t_policy) if policy else None}


def print_summary(who: str, summary: dict) -> None:
    print(f"{who} summary {json.dumps(summary)}", flush=True)


class Publisher:
    """The learner's side of the params broadcast: times each publish and,
    with --diagnostics, prints each published version's digest."""

    def __init__(self, server: TrainerServer, diagnostics: bool):
        self.server, self.diagnostics = server, diagnostics
        self.versions, self.layout_s, self.send_s, self.digest_s = 0, 0.0, 0.0, 0.0

    def __call__(self, agent) -> None:
        t0 = time.perf_counter()
        tree = to_jax_layout(agent)
        t1 = time.perf_counter()
        self.server.publish_network(tree)
        self.layout_s += t1 - t0
        self.send_s += time.perf_counter() - t1
        if self.diagnostics:
            t2 = time.perf_counter()
            print(f"learner published version {self.versions} digest {digest(tree)}", flush=True)
            self.digest_s += time.perf_counter() - t2
        self.versions += 1

    def summary(self) -> dict:
        """Mean ms a publish: in all, the params' device-to-host layout
        (to_jax_layout) and the encoding and sending; and the digest's
        (--diagnostics), outside the publish."""
        n = max(self.versions, 1)
        return {"publishes": self.versions,
                "publish_ms": 1e3 * (self.layout_s + self.send_s) / n,
                "publish_layout_ms": 1e3 * self.layout_s / n,
                "publish_send_ms": 1e3 * self.send_s / n,
                "digest_ms": 1e3 * self.digest_s / n}


def stats_callback(req_type, payload):
    print("actor stats:", payload, flush=True)
    return {"ok": True}


def wait_for_data(replay, training_starts: int) -> int:
    print("waiting for data...", flush=True)
    while len(replay) < training_starts:
        time.sleep(0.5)
    return len(replay)


def make_actor_client(cfg: WorkloadConfig, capacity: int):
    """(queue, client, newest params) of an actor: the client subscribed to
    the learner's broadcasts."""
    data_store = QueuedDataStore(capacity)
    client = TrainerClient("actor_env", cfg.ip, cfg.trainer_config(), data_store,
                           wait_for_server=True)
    latest = LatestParams()
    client.recv_network_callback(latest.put)
    return data_store, client, latest


def load_newest(latest: LatestParams, agent, args, timer: Timer) -> None:
    """Load the newest published version, if one came; with --diagnostics
    print the digest of the params the agent then holds (timed apart)."""
    with timer.context("load_params"):
        loaded = latest.load_into(agent)
    if loaded and args.diagnostics:
        with timer.context("digest"):
            print(f"actor loaded params digest {digest(to_jax_layout(agent))}", flush=True)


def actor_loop(cfg: WorkloadConfig, args):
    device = resolve_device(args.device)
    env = PandaPickCubeEnv(device=device)
    agent = make_sac_agent(cfg.seed, device=device)
    data_store, client, latest = make_actor_client(cfg, 2000)
    g = torch.Generator(device=device).manual_seed(cfg.seed)

    state, obs_d = env.reset(1, g)
    obs = flatten_obs(obs_d)
    obs_np = obs[0].cpu().numpy()
    timer = Timer()
    ep_ret, ep_count = 0.0, 0
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
            obs = flatten_obs(next_obs_d)
        with timer.context("to_host"):  # waits for the step's kernels
            tr, obs_np_next = transition(obs_np, action, obs, reward, done)
        data_store.insert(tr)
        obs_np = obs_np_next
        ep_ret += float(tr["rewards"])
        if tr["dones"] > 0.5:
            ep_count += 1
            state, obs_d = env.reset(1, g)
            obs = flatten_obs(obs_d)
            obs_np = obs[0].cpu().numpy()
            if ep_count % 5 == 0:
                client.request("send-stats", {"episode_return": ep_ret, "episodes": ep_count})
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
        "versions_received": latest.received,
        "versions_loaded": latest.loaded, "times": timer.get_average_times(),
        **kernel_report(args)})


def learner_loop(cfg: WorkloadConfig, args):
    device = resolve_device(args.device)
    agent = make_sac_agent(cfg.seed, device=device)
    replay = ReplayBufferDataStore(example_transition(), capacity=cfg.buffer_capacity)
    server = TrainerServer(cfg.trainer_config(), request_callback=stats_callback)
    server.register_data_store("actor_env", replay)
    server.start(threaded=True)
    ring_at_start = wait_for_data(replay, cfg.training_starts)

    publish = Publisher(server, args.diagnostics)
    publish(agent)
    rng = np.random.default_rng(cfg.seed)
    g = torch.Generator(device=device).manual_seed(cfg.seed)
    iterator = replay.get_iterator(cfg.batch_size * cfg.utd_ratio, device, rng=rng)
    timer = Timer()
    losses = []
    t0 = time.perf_counter()
    for update_step in range(args.max_steps):
        with timer.context("sample_replay_buffer"):
            batch = next(iterator)
        with timer.context("train"):
            agent, info = agent.update_high_utd(batch, utd_ratio=cfg.utd_ratio, generator=g)
            losses.append(float(info["critic"]["critic_loss"]))  # waits for the update
        if update_step % cfg.publish_period == 0:
            publish(agent)
        if update_step % args.log_period == 0:
            print(f"update {update_step} closs {losses[-1]:.4f} buffer {len(replay)} "
                  f"times {timer.get_average_times(reset=False)}", flush=True)
    seconds = time.perf_counter() - t0
    server.stop()
    print_summary("learner", learner_summary(cfg, args, seconds, losses, replay, ring_at_start,
                                             publish, timer))


def learner_summary(cfg, args, seconds, losses, replay, ring_at_start, publish, timer) -> dict:
    return {"updates": args.max_steps, "updates_s": args.max_steps / seconds,
            "batch_size": cfg.batch_size, "utd_ratio": cfg.utd_ratio,
            "training_starts": cfg.training_starts,
            "seconds": seconds, "critic_loss_first": losses[0] if losses else None,
            "critic_loss_last": losses[-1] if losses else None,
            "critic_loss_finite": all(math.isfinite(v) for v in losses),
            "ring_at_start": ring_at_start, "ring": len(replay),
            "transitions_received": replay.latest_data_id(), **publish.summary(),
            "times": timer.get_average_times(), **kernel_report(args)}


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags both examples share; each adds its own defaults."""
    p.add_argument("--learner", action="store_true")
    p.add_argument("--actor", action="store_true")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5488)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=1_000_000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--training_starts", type=int, default=1000)
    p.add_argument("--random_steps", type=int, default=1000)
    p.add_argument("--steps_per_update", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--diagnostics", action="store_true",
                   help="print every published and loaded version's digest, and each "
                        "kernel's launches and K5's shapes at the end")


def main(argv=None):
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--critic_actor_ratio", type=int, default=8)
    p.add_argument("--publish_period", type=int, default=1)
    p.add_argument("--log_period", type=int, default=100)
    p.add_argument("--replay_capacity", type=int, default=1_000_000)
    args = p.parse_args(argv)
    if args.learner == args.actor:
        raise SystemExit("pass exactly one of --learner/--actor")
    # one WorkloadConfig drives both processes; the reference's flag names
    # (--critic_actor_ratio etc.) map onto it
    cfg = WorkloadConfig.preset(
        "state_sim", ip=args.ip, port=args.port, seed=args.seed, batch_size=args.batch_size,
        utd_ratio=args.critic_actor_ratio, training_starts=args.training_starts,
        random_steps=args.random_steps, steps_per_update=args.steps_per_update,
        publish_period=args.publish_period, buffer_capacity=args.replay_capacity,
        total_env_steps=args.max_steps)
    start_diagnostics(args)
    (learner_loop if args.learner else actor_loop)(cfg, args)


if __name__ == "__main__":
    main()
