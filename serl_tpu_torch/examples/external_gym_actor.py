"""An external gym-API actor attached to the TrainerServer learner.

Port of `examples/external_gym_actor.py`: the actor side is written only
against (a) the reference FrankaEnv dict surface through the gym API
(observation {"state": {tcp_pose, tcp_vel, gripper_pose, tcp_force,
tcp_torque}, "images": {...}}, a 7-dim delta-pose action), flattened as the
reference's SERLObsWrapper does (`serl_obs_flatten`), and (b) the
TrainerClient surface (`distributed/transport.py`). Swap the env for a real
FrankaEnv and the actor runs unchanged; here the stand-in robot is the
pose-task env behind `envs/gym_adapter.py::FrankaTaskGymEnv`. The learner is
the TrainerServer SAC learner of the two-process mode (OBS_DIM 16, ACT_DIM 7,
batch 256 x `critic_actor_ratio` 4 by default).

    python -m serl_tpu_torch.examples.external_gym_actor --learner
    python -m serl_tpu_torch.examples.external_gym_actor --actor [--ip 127.0.0.1]

Both processes run on the CUDA card unless `--device cpu`. `actor_loop`
takes the env and the random-action draw as arguments: by default
`gym.make("FrankaPegInsert-v0")` (this package's ids registered with the
actor's device) and its `action_space.sample`; a machine without gymnasium
passes `FrankaTaskGymBase`, the same env without the gym layer, and a
uniform draw in [-1, 1] (`main(argv, env=..., random_action=...)`). The
actor loads the newest published params at the top of a step, as the
two-process examples do. Each process ends with one `actor summary {...}` /
`learner summary {...}` JSON line.
"""

import argparse
import time

import numpy as np
import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.data.host_buffer import ReplayBufferDataStore
from serl_tpu_torch.distributed.transport import (
    QueuedDataStore,
    TrainerClient,
    TrainerConfig,
    TrainerServer,
)
from serl_tpu_torch.examples.async_sac_state_sim import (
    LatestParams,
    Publisher,
    kernel_report,
    print_summary,
    start_diagnostics,
)
from serl_tpu_torch.training.launcher import make_sac_agent

OBS_DIM = 16  # sorted state keys: gripper(1)+force(3)+pose(6)+torque(3)+vel(3)
ACT_DIM = 7


def serl_obs_flatten(obs):
    """The reference SERLObsWrapper: the state dict flattened to one vector
    (sorted keys), images lifted to the top level."""
    state = obs["state"]
    flat = np.concatenate([np.asarray(state[k], np.float32).ravel() for k in sorted(state)])
    out = {"state": flat}
    for k, v in obs.get("images", {}).items():
        out[k] = v
    return out


def trainer_config(port):
    return TrainerConfig(port_number=port, broadcast_port=port + 1,
                         request_types=["send-stats"])


def example_transition() -> dict:
    return {"observations": np.zeros(OBS_DIM, np.float32),
            "actions": np.zeros(ACT_DIM, np.float32),
            "next_observations": np.zeros(OBS_DIM, np.float32),
            "rewards": np.float32(0), "masks": np.float32(0), "dones": np.float32(0)}


def actor_loop(args, env=None, random_action=None):
    """The reference actor loop against a gym-API env and the TrainerClient
    only: `env` (gym.make("FrankaPegInsert-v0") by default) and
    `random_action()` (its action_space.sample by default) for the first
    `random_steps` steps, the policy's draw after."""
    device = resolve_device(args.device)
    if env is None:
        import gymnasium as gym

        from serl_tpu_torch.envs.gym_adapter import register_envs

        register_envs(device=str(device))
        env = gym.make("FrankaPegInsert-v0")
    if random_action is None:
        random_action = env.action_space.sample
    agent = make_sac_agent(seed=args.seed, obs_dim=OBS_DIM, action_dim=ACT_DIM, device=device)
    data_store = QueuedDataStore(2000)
    client = TrainerClient("actor_env", args.ip, trainer_config(args.port), data_store,
                           wait_for_server=True)
    latest = LatestParams()
    client.recv_network_callback(latest.put)
    g = torch.Generator(device=device).manual_seed(args.seed)

    raw_obs, _ = env.reset(seed=args.seed)
    obs = serl_obs_flatten(raw_obs)
    ep_count = 0
    t0 = t_policy = time.perf_counter()
    for step_i in range(args.max_steps):
        latest.load_into(agent)
        if step_i < args.random_steps:
            action = random_action()
        else:
            if step_i == args.random_steps:
                t_policy = time.perf_counter()
            state = torch.as_tensor(obs["state"], device=device)[None]
            action = agent.sample_actions(state, generator=g)[0].cpu().numpy()
        raw_next, reward, terminated, truncated, info = env.step(action)
        next_obs = serl_obs_flatten(raw_next)
        done = terminated or truncated
        data_store.insert({
            "observations": obs["state"],
            "actions": np.asarray(action, np.float32),
            "next_observations": next_obs["state"],
            "rewards": np.float32(reward),
            "masks": np.float32(1.0 - float(terminated)),
            "dones": np.float32(done),
        })
        obs = next_obs
        if done:
            ep_count += 1
            raw_obs, _ = env.reset()
            obs = serl_obs_flatten(raw_obs)
            if ep_count % 5 == 0:
                client.request("send-stats", {"episodes": ep_count})
        if step_i % args.steps_per_update == 0:
            client.update()
        if step_i % 500 == 0:
            print(f"actor step {step_i}, episodes {ep_count}", flush=True)
    t_end = time.perf_counter()
    client.update()
    client.stop()
    print(f"actor done: {ep_count} episodes", flush=True)
    policy_steps = args.max_steps - min(args.random_steps, args.max_steps)
    print_summary("actor", {
        "steps": args.max_steps, "env_steps_s": args.max_steps / (t_end - t0),
        "env_steps_s_policy": policy_steps / (t_end - t_policy) if policy_steps else None,
        "seconds": t_end - t0, "episodes": ep_count, "versions_received": latest.received,
        "versions_loaded": latest.loaded, **kernel_report(args)})


def learner_loop(args):
    device = resolve_device(args.device)
    agent = make_sac_agent(seed=args.seed, obs_dim=OBS_DIM, action_dim=ACT_DIM, device=device)
    replay = ReplayBufferDataStore(example_transition(), capacity=50_000)

    def stats_cb(req_type, payload):
        print("actor stats:", payload, flush=True)
        return {"ok": True}

    server = TrainerServer(trainer_config(args.port), request_callback=stats_cb)
    server.register_data_store("actor_env", replay)
    server.start(threaded=True)
    print("waiting for data...", flush=True)
    while len(replay) < args.training_starts:
        time.sleep(0.2)
    ring_at_start = len(replay)

    publish = Publisher(server, args.diagnostics)
    rng = np.random.default_rng(args.seed)
    g = torch.Generator(device=device).manual_seed(args.seed)
    iterator = replay.get_iterator(args.batch_size * args.critic_actor_ratio, device, rng=rng)
    losses = []
    t0 = time.perf_counter()
    for update_i in range(1, args.max_steps + 1):
        _, infos = agent.update_high_utd(next(iterator), utd_ratio=args.critic_actor_ratio,
                                         generator=g)
        losses.append(float(infos["critic"]["critic_loss"]))
        if update_i % args.steps_per_publish == 0:
            publish(agent)
        if update_i % 10 == 0:
            print(f"update {update_i} buffer {len(replay)} critic_loss {losses[-1]:.4f}",
                  flush=True)
    seconds = time.perf_counter() - t0
    publish(agent)
    server.stop()
    print("learner done", flush=True)
    print_summary("learner", {
        "updates": args.max_steps, "updates_s": args.max_steps / seconds, "seconds": seconds,
        "batch_size": args.batch_size, "utd_ratio": args.critic_actor_ratio,
        "training_starts": args.training_starts,
        "critic_loss_first": losses[0] if losses else None,
        "critic_loss_last": losses[-1] if losses else None,
        "critic_loss_finite": bool(np.isfinite(losses).all()), "ring_at_start": ring_at_start,
        "ring": len(replay), "transitions_received": replay.latest_data_id(),
        **publish.summary(), **kernel_report(args)})


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--actor", action="store_true")
    p.add_argument("--learner", action="store_true")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5488)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--random_steps", type=int, default=300)
    p.add_argument("--steps_per_update", type=int, default=30)
    p.add_argument("--steps_per_publish", type=int, default=10)
    p.add_argument("--training_starts", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--critic_actor_ratio", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--diagnostics", action="store_true",
                   help="print every published version's digest, and each kernel's launches "
                        "and K5's shapes at the end")
    return p


def main(argv=None, env=None, random_action=None):
    args = parser().parse_args(argv)
    if args.actor == args.learner:
        raise SystemExit("pass exactly one of --actor / --learner")
    start_diagnostics(args)
    if args.actor:
        actor_loop(args, env, random_action)
    else:
        learner_loop(args)


if __name__ == "__main__":
    main()
