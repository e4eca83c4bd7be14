"""Actor/learner training loop over N lockstep envs.

Port of `serl_tpu/training/loop.py::make_fused_loop` and `evaluate`, for
state observations (flat vectors) and pixels (the SERL flat convention
{"state": vec, "<image key>": frame}: the buffer stores single frames and
the agent sees an explicit T = 1 stack axis). Per iteration every env takes one step (uniform random
actions while `env_steps < random_steps`, policy samples after), the
transitions go into the (slots, streams) replay ring, and the episode
statistics are kept on the device. Once the buffer holds
max(training_starts, batch_size * utd_ratio) rows, counted after the
insert on host integers, the learner runs `updates_per_iter` x (sample ->
`update_high_utd`) every iteration. The JAX package runs a chunk of
iterations as one jitted `lax.scan`; here it is a Python loop over eager
PyTorch and the kernels, with no host sync inside an iteration.

Not ported yet, and raising rather than passing silently: the loop's
frame-stack history (`num_stack > 1`), demo buffers and interventions.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBuffer, ReplayBufferState
from serl_tpu_torch.envs.panda_pick import ACTION_DIM, PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.envs.wrappers import add_stack_axis, serl_obs


class LoopConfig(NamedTuple):
    """The JAX package's LoopConfig, cut to the fields the port reads: the
    demo and intervention settings come with their code."""

    num_envs: int = 128
    batch_size: int = 256
    utd_ratio: int = 8  # critic updates per actor update (critic_actor_ratio)
    updates_per_iter: int = 1  # update_high_utd calls per env sweep
    training_starts: int = 1000  # transitions before learning
    random_steps: int = 1000  # uniform-random action warmup
    buffer_capacity: int = 200_000
    intervention_prob: float = 0.0  # interventions are not ported: > 0 raises


class LoopCarry(NamedTuple):
    agent: SACAgent
    env_states: Any
    obs: Any  # flattened (N, obs_dim), or the SERL pixel dict
    rb_state: ReplayBufferState
    rng: torch.Generator  # on the env's device
    env_steps: int  # total transitions collected
    ep_return: torch.Tensor  # (N,) running episode returns
    ep_count: torch.Tensor  # () int32 completed episodes
    ret_sum: torch.Tensor  # () sum of completed episode returns
    succ_sum: torch.Tensor  # () sum of per-episode success at episode end


def _generator(rng: Union[int, torch.Generator, None], device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(0 if rng is None else int(rng))


def make_fused_loop(env: PandaPickCubeEnv, rb: ReplayBuffer, config: LoopConfig,
                    expert_fn=None):
    """Returns (init_fn, run_chunk).

    init_fn(agent, rng, demo_state=None) -> LoopCarry, where `rng` is a
    torch.Generator on the env's device or an int seed (a demo buffer is not
    ported yet and raises);
    run_chunk(carry, num_iters) -> (carry, metrics dict of (num_iters,) tensors)
    with the JAX package's metric names.
    """
    pixel_keys = rb.image_keys
    if pixel_keys and rb.num_stack > 1:
        raise NotImplementedError("the loop's frame-stack history (num_stack > 1) is not ported yet")
    if pixel_keys and rb.store_next_obs:
        raise NotImplementedError("pixel buffers that store next_observations are not ported")
    if config.intervention_prob > 0.0 or expert_fn is not None:
        raise NotImplementedError("interventions are not ported yet")
    action_dim = getattr(env, "ACTION_DIM", ACTION_DIM)
    num_envs = config.num_envs
    device = env.device
    # rb_state.size counts SLOTS; each slot holds num_envs transitions
    train_threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    env_index = torch.arange(num_envs, dtype=torch.int32, device=device)

    def to_buffer_obs(obs_dict):
        return serl_obs(obs_dict) if pixel_keys else flatten_obs(obs_dict)

    def to_agent_obs(obs):
        return add_stack_axis(obs, pixel_keys) if pixel_keys else obs

    def init_fn(agent, rng, demo_state=None):
        if demo_state is not None:
            raise NotImplementedError("demo buffers are not ported yet")
        g = _generator(rng, device)
        env_states, obs = env.reset(num_envs, g)
        zero = torch.zeros((), device=device)
        return LoopCarry(
            agent=agent,
            env_states=env_states,
            obs=to_buffer_obs(obs),
            rb_state=rb.init_state(streams=num_envs),
            rng=g,
            env_steps=0,
            ep_return=torch.zeros((num_envs,), device=device),
            ep_count=torch.zeros((), dtype=torch.int32, device=device),
            ret_sum=zero,
            succ_sum=zero.clone(),
        )

    def iter_body(carry: LoopCarry):
        g = carry.rng

        # ---- actor: one step for every env ----
        if carry.env_steps < config.random_steps:
            actions = torch.rand((num_envs, action_dim), generator=g, device=device) * 2.0 - 1.0
        else:
            actions = carry.agent.sample_actions(to_agent_obs(carry.obs), generator=g)
        # the pre-reset observation is a second render with pixels: ask for
        # it only where the buffer stores it
        env_states, next_obs_d, rewards, dones, info = env.step_auto_reset(
            carry.env_states, actions, generator=g, final_obs=rb.store_next_obs
        )
        next_obs = to_buffer_obs(next_obs_d)

        transitions = {
            "observations": carry.obs,
            "actions": actions,
            "rewards": rewards,
            # masks = 1 - done: bootstrap cut at the time limit
            "masks": 1.0 - dones,
            "dones": dones,
        }
        if rb.store_next_obs:
            # the pre-reset terminal obs is the true successor
            transitions["next_observations"] = to_buffer_obs(info["final_obs"])
        ep_ids = carry.env_states.ep_id * num_envs + env_index
        rb_state = rb.insert(carry.rb_state, transitions, ep_ids)

        # ---- episode stats ----
        ep_return = carry.ep_return + rewards
        done_mask = dones > 0.5
        ep_count = carry.ep_count + done_mask.sum().to(torch.int32)
        ret_sum = carry.ret_sum + torch.where(done_mask, ep_return, 0.0).sum()
        succ_sum = carry.succ_sum + torch.where(done_mask, info["success"], 0.0).sum()
        ep_return = torch.where(done_mask, 0.0, ep_return)
        env_steps = carry.env_steps + num_envs

        # ---- learner ----
        if rb_state.size * num_envs >= train_threshold:
            infos = []
            for _ in range(config.updates_per_iter):
                batch = rb.sample(rb_state, config.batch_size * config.utd_ratio, generator=g)
                _, update_info = carry.agent.update_high_utd(batch, utd_ratio=config.utd_ratio,
                                                             generator=g)
                infos.append(update_info)
            learner = {
                "critic_loss": torch.stack([i["critic"]["critic_loss"] for i in infos]).mean(),
                **{k: torch.stack([i["actor"][k] for i in infos]).mean()
                   for k in ("actor_loss", "temperature", "entropy")},
            }
        else:
            zero = torch.zeros((), device=device)  # no learner update ran
            learner = dict.fromkeys(("critic_loss", "actor_loss", "temperature", "entropy"), zero)

        metrics = {
            "reward_mean": rewards.mean(),
            "env_steps": torch.tensor(env_steps, dtype=torch.int32),
            "buffer_size": torch.tensor(rb_state.size * num_envs, dtype=torch.int32),
            **learner,
            "ep_count": ep_count,
            "ret_sum": ret_sum,
            "succ_sum": succ_sum,
        }
        new_carry = carry._replace(
            env_states=env_states, obs=next_obs, rb_state=rb_state, env_steps=env_steps,
            ep_return=ep_return, ep_count=ep_count, ret_sum=ret_sum, succ_sum=succ_sum,
        )
        return new_carry, metrics

    def run_chunk(carry: LoopCarry, num_iters: int):
        history = []
        for _ in range(num_iters):
            carry, metrics = iter_body(carry)
            history.append(metrics)
        stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]} if history else {}
        return carry, stacked

    return init_fn, run_chunk


@torch.no_grad()
def evaluate(env: PandaPickCubeEnv, agent: SACAgent, rng=None, num_episodes: int = 32,
             pixel_keys=(), num_stack: int = 1):
    """Deterministic (argmax) policy evaluation: `num_episodes` full episodes
    in lockstep, each `env.time_limit_steps` long. `rng` (a torch.Generator on
    the env's device, or an int seed) draws the reset cube positions.
    `pixel_keys` switches the observations to the SERL pixel convention
    with a T = 1 stack axis (a longer stack is not ported yet)."""
    if num_stack != 1:
        raise NotImplementedError("frame-stack histories (num_stack > 1) are not ported yet")
    pixel_keys = tuple(pixel_keys)

    def obs_fn(o):
        return add_stack_axis(serl_obs(o), pixel_keys) if pixel_keys else flatten_obs(o)

    episode_len = int(getattr(env, "time_limit_steps", 100))
    states, obs = env.reset(num_episodes, _generator(rng, env.device))
    ret = torch.zeros((num_episodes,), device=env.device)
    succ = torch.zeros((num_episodes,), device=env.device)
    for _ in range(episode_len):
        actions = agent.sample_actions(obs_fn(obs), argmax=True)
        states, obs, r, _, info = env.step(states, actions)
        ret = ret + r
        succ = torch.maximum(succ, info["success"])
    return {
        "eval/return_mean": float(ret.mean()),
        "eval/success_rate": float(succ.mean()),
    }
