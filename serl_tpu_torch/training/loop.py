"""Actor/learner training loop over N lockstep envs.

Port of `serl_tpu/training/loop.py::make_fused_loop` and `evaluate`, for
state observations (flat vectors) and pixels (the SERL flat convention
{"state": vec, "<image key>": frame}: the buffer stores single frames and
the agent sees an explicit stack axis of T = the ring's `num_stack`
frames). Per iteration every env takes one step (uniform random
actions while `env_steps < random_steps`, policy samples after), the
transitions go into the (slots, streams) replay ring, and the episode
statistics are kept on the device. Once the buffer holds
max(training_starts, batch_size * utd_ratio) rows, counted after the
insert on host integers, the learner runs `updates_per_iter` x (sample ->
`update_high_utd`) every iteration. The JAX package runs a chunk of
iterations as one jitted `lax.scan`; here it is a Python loop over eager
PyTorch and the kernels, with no host sync inside an iteration.

RLPD: with `demo_fraction > 0` and a demo ring passed to `init_fn`, every
learner batch is `sample_mixed`'s half-demo one (`demo_fraction` acts as a
flag, as in the JAX package). Interventions: a scripted expert overrides the
policy's action, and the expert's action is the one stored, per step
("step"), for whole episodes ("episode") or from a step to the episode's
end ("rescue"), with a probability that may decay linearly to a floor over
the env steps (computed on the host from the host-integer step count).

Data parallelism (`dp`, a `distributed.sharding.DataParallel`; the carry
cut by `shard_carry`): each rank steps its share of the envs and keeps
their ring streams, and every iteration draws what the 1-rank loop draws,
at the global shapes (random actions, the policy's noise, interventions,
resets, replay offsets), keeping the rank's rows. Env indices, the env
count of the learner's gate and `env_steps` are global; the episode
statistics and `reward_mean` are summed over the ranks (one all-reduce an
iteration); each sample hands the rank its share of every minibatch, and
the optimizer steps average the gradients over the ranks.

Frame stacks (`num_stack > 1`): the carry's `chunk` holds each env's
last T frames of every camera (`envs/wrappers.py::chunk_init` /
`chunk_push`), which the policy sees; where an episode ends the history
restarts filled with the post-reset frame. A pixel ring that stores
next_observations asks the env for the pre-reset terminal frame (a second
render) and stores it; its samples stack the next_observations' cameras
from the observations ring, as the JAX package does
(`data/replay_buffer.py`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch

from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBuffer, ReplayBufferState
from serl_tpu_torch.distributed.sharding import local
from serl_tpu_torch.envs.panda_pick import ACTION_DIM, PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.envs.wrappers import ChunkState, add_stack_axis, chunk_init, chunk_push, serl_obs
from serl_tpu_torch.utils.timer import span

INTERVENTION_MODES = ("step", "episode", "rescue")


class LoopConfig(NamedTuple):
    num_envs: int = 128
    batch_size: int = 256
    utd_ratio: int = 8  # critic updates per actor update (critic_actor_ratio)
    updates_per_iter: int = 1  # update_high_utd calls per env sweep
    training_starts: int = 1000  # transitions before learning
    random_steps: int = 1000  # uniform-random action warmup
    buffer_capacity: int = 200_000
    demo_fraction: float = 0.0  # > 0: RLPD's half-demo batches (a flag, not a fraction)
    # the expert overrides the policy, and its action is stored: "step", a
    # fresh Bernoulli(prob) per env and step; "episode", whole episodes,
    # drawn at each episode's start; "rescue", from a Bernoulli(prob) step
    # to the end of that episode
    intervention_prob: float = 0.0
    intervention_mode: str = "step"
    intervention_decay_steps: Optional[int] = None  # linear decay to 0 over these env steps
    intervention_min_prob: float = 0.0  # the decayed probability's floor


class LoopCarry(NamedTuple):
    agent: SACAgent
    env_states: Any
    obs: Any  # flattened (N, obs_dim), or the SERL pixel dict
    rb_state: ReplayBufferState
    demo_state: Optional[ReplayBufferState]
    rng: torch.Generator  # on the env's device
    env_steps: int  # total transitions collected
    ep_return: torch.Tensor  # (N,) running episode returns
    ep_count: torch.Tensor  # () int32 completed episodes
    ret_sum: torch.Tensor  # () sum of completed episode returns
    succ_sum: torch.Tensor  # () sum of per-episode success at episode end
    intervening: torch.Tensor  # (N,) bool: the expert owns this env's episode
    # each env's last num_stack frames of every camera; None when num_stack == 1
    chunk: Optional[ChunkState] = None


def intervention_probability(config: LoopConfig, env_steps: int) -> float:
    """The intervention probability after `env_steps` env steps: decayed
    linearly to 0 over `intervention_decay_steps`, floored at
    `intervention_min_prob` (both only when a decay is set)."""
    p = config.intervention_prob
    if config.intervention_decay_steps:
        frac = min(max(1.0 - env_steps / float(config.intervention_decay_steps), 0.0), 1.0)
        p = max(p * frac, config.intervention_min_prob)
    return p


def _generator(rng: Union[int, torch.Generator, None], device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(0 if rng is None else int(rng))


def make_fused_loop(env: PandaPickCubeEnv, rb: ReplayBuffer, config: LoopConfig,
                    expert_fn=None, dp=None):
    """Returns (init_fn, run_chunk).

    `dp` (a `distributed.sharding.DataParallel`; the env's `step_auto_reset`
    takes it and draws its resets at the global shape): run_chunk takes this
    rank's share of the carry (`shard_carry` of init_fn's).

    init_fn(agent, rng, demo_state=None) -> LoopCarry (at the global size), where `rng` is a
    torch.Generator on the env's device or an int seed, and `demo_state` a
    demo ring (`data/demos.py::demos_to_buffer`) for RLPD;
    run_chunk(carry, num_iters) -> (carry, metrics dict of (num_iters,) tensors)
    with the JAX package's metric names.

    `expert_fn(env_states) -> (N, action_dim)` (or one action for every
    env) is the intervening expert; by default the scripted pick expert
    without noise.
    """
    if config.intervention_mode not in INTERVENTION_MODES:
        raise ValueError(f"intervention_mode must be 'step', 'episode' or 'rescue', got "
                         f"{config.intervention_mode!r}")
    pixel_keys = rb.image_keys
    num_stack = rb.num_stack if pixel_keys else 1
    if expert_fn is None:
        expert_fn = expert_action
    action_dim = getattr(env, "ACTION_DIM", ACTION_DIM)
    num_envs = config.num_envs  # all ranks' envs
    device = env.device
    intervenes = config.intervention_prob > 0.0
    mode = config.intervention_mode
    # rb_state.size counts SLOTS; each slot holds num_envs transitions
    train_threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    env_index = torch.arange(num_envs, dtype=torch.int32, device=device)
    step_kw = {} if dp is None else {"dp": dp}

    def to_buffer_obs(obs_dict):
        return serl_obs(obs_dict) if pixel_keys else flatten_obs(obs_dict)

    def to_agent_obs(obs, chunk):
        """Buffer obs -> the agent's: each camera with its stack axis, the
        env's history from `chunk` when num_stack > 1."""
        if not pixel_keys:
            return obs
        if num_stack == 1:
            return add_stack_axis(obs, pixel_keys)
        return {**obs, **{k: chunk.frames[k] for k in pixel_keys}}

    def images(obs):
        return {k: obs[k] for k in pixel_keys}

    def draw(g, p: float) -> torch.Tensor:
        return torch.rand((num_envs,), generator=g, device=device) < p

    def init_fn(agent, rng, demo_state=None):
        g = _generator(rng, device)
        env_states, obs = env.reset(num_envs, g)
        intervening = (draw(g, config.intervention_prob) if mode == "episode"
                       else torch.zeros((num_envs,), dtype=torch.bool, device=device))
        zero = torch.zeros((), device=device)
        obs = to_buffer_obs(obs)
        return LoopCarry(
            agent=agent,
            env_states=env_states,
            obs=obs,
            rb_state=rb.init_state(streams=num_envs),
            demo_state=demo_state,
            rng=g,
            env_steps=0,
            ep_return=torch.zeros((num_envs,), device=device),
            ep_count=torch.zeros((), dtype=torch.int32, device=device),
            ret_sum=zero,
            succ_sum=zero.clone(),
            intervening=intervening,
            chunk=chunk_init(images(obs), num_stack) if num_stack > 1 else None,
        )

    def iter_body(carry: LoopCarry):
        with span("loop.iteration", iteration=carry.env_steps // num_envs):
            return iteration(carry)

    def iteration(carry: LoopCarry):
        g = carry.rng

        # ---- actor: one step for every env ----
        if carry.env_steps < config.random_steps:
            actions = local(torch.rand((num_envs, action_dim), generator=g, device=device),
                            dp) * 2.0 - 1.0
        else:
            noise = local(torch.randn((num_envs, action_dim), generator=g, device=device), dp)
            actions = carry.agent.sample_actions(to_agent_obs(carry.obs, carry.chunk), noise=noise)
        intervening = carry.intervening
        if intervenes:
            p = intervention_probability(config, carry.env_steps)
            if mode == "episode":
                intervene = intervening
            elif mode == "rescue":
                intervene = intervening = intervening | local(draw(g, p), dp)
            else:
                intervene = local(draw(g, p), dp)
            actions = torch.where(intervene[:, None], expert_fn(carry.env_states), actions)
        # the pre-reset observation is a second render with pixels: ask for
        # it only where the buffer stores it
        env_states, next_obs_d, rewards, dones, info = env.step_auto_reset(
            carry.env_states, actions, generator=g, final_obs=rb.store_next_obs, **step_kw
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
        ep_ids = carry.env_states.ep_id * num_envs + local(env_index, dp)
        rb_state = rb.insert(carry.rb_state, transitions, ep_ids)

        # ---- episode stats (summed over the ranks) ----
        ep_return = carry.ep_return + rewards
        done_mask = dones > 0.5
        done_count = done_mask.sum()
        ret_done = torch.where(done_mask, ep_return, 0.0).sum()
        succ_done = torch.where(done_mask, info["success"], 0.0).sum()
        if dp is None:
            reward_mean = rewards.mean()
        else:
            sums = dp.all_reduce_sum_(torch.stack([rewards.sum(), done_count.to(torch.float32),
                                                   ret_done, succ_done]))
            reward_mean, done_count, ret_done, succ_done = sums[0] / num_envs, *sums[1:]
        ep_count = carry.ep_count + done_count.to(torch.int32)
        ret_sum = carry.ret_sum + ret_done
        succ_sum = carry.succ_sum + succ_done
        ep_return = torch.where(done_mask, 0.0, ep_return)
        chunk = carry.chunk
        if num_stack > 1:
            # push the stepped-to frame; where an episode ended, restart the
            # history filled with the post-reset frame
            frames = images(next_obs)
            pushed = chunk_push(chunk, frames).frames
            fresh = chunk_init(frames, num_stack).frames
            chunk = ChunkState(frames={
                k: torch.where(done_mask.reshape((-1,) + (1,) * (pushed[k].dim() - 1)),
                               fresh[k], pushed[k]) for k in pixel_keys})
        if intervenes and mode == "episode":
            # the expert's ownership of each new episode is drawn as it starts
            intervening = torch.where(done_mask, local(draw(g, p), dp), intervening)
        elif mode == "rescue":
            # a rescue never carries across an episode boundary
            intervening = intervening & ~done_mask
        env_steps = carry.env_steps + num_envs

        # ---- learner ----
        if rb_state.size * num_envs >= train_threshold:
            rows = config.batch_size * config.utd_ratio
            infos = []
            for _ in range(config.updates_per_iter):
                if config.demo_fraction > 0.0 and carry.demo_state is not None:
                    batch = rb.sample_mixed(rb_state, carry.demo_state, rows, generator=g,
                                            dp=dp)
                else:
                    batch = rb.sample(rb_state, rows, generator=g, dp=dp)
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
            "reward_mean": reward_mean,
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
            intervening=intervening, chunk=chunk,
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
             obs_fn=None, pixel_keys=(), num_stack: int = 1):
    """Deterministic (argmax) policy evaluation: `num_episodes` full episodes
    in lockstep, each `env.time_limit_steps` long. `rng` (a torch.Generator on
    the env's device, or an int seed) draws the reset cube positions.
    `obs_fn` maps the env's observation dict to the agent's input; by
    default the flat state vector, or with `pixel_keys` the SERL pixel
    convention with a T = 1 stack axis. With pixel keys and `num_stack` > 1
    the agent sees each episode's last `num_stack` frames of every camera
    (the first frame repeated at the start), and `obs_fn` is not used, as in
    the JAX package."""
    pixel_keys = tuple(pixel_keys)
    chunked = bool(pixel_keys) and num_stack > 1
    if obs_fn is None:
        def obs_fn(o):
            return add_stack_axis(serl_obs(o), pixel_keys) if pixel_keys else flatten_obs(o)

    def images(o):
        flat = serl_obs(o)
        return {k: flat[k] for k in pixel_keys}

    episode_len = int(getattr(env, "time_limit_steps", 100))
    states, obs = env.reset(num_episodes, _generator(rng, env.device))
    chunk = chunk_init(images(obs), num_stack) if chunked else None
    ret = torch.zeros((num_episodes,), device=env.device)
    succ = torch.zeros((num_episodes,), device=env.device)
    for _ in range(episode_len):
        aobs = {**serl_obs(obs), **chunk.frames} if chunked else obs_fn(obs)
        actions = agent.sample_actions(aobs, argmax=True)
        states, obs, r, _, info = env.step(states, actions)
        if chunked:
            chunk = chunk_push(chunk, images(obs))
        ret = ret + r
        succ = torch.maximum(succ, info["success"])
    return {
        "eval/return_mean": float(ret.mean()),
        "eval/success_rate": float(succ.mean()),
    }
