"""Forward/backward dual-policy training (bin relocation, E6).

Port of `serl_tpu/training/fwbw.py`: `FwBwConfig`, the isolated program
(`TaskCarry`, `FwBwCarry`, `make_fwbw_loop`, `evaluate_chained`), and the
chained one (`ChainedCarry`, `make_chained_loop`, `collect_chained_demos`,
`evaluate_chained_env`).
Two agents, two task-routed rings and one batch of reset-free
`ChainedBinEnv` envs whose task flips at success: each iteration every env
steps once under the policy of its task (uniform random actions before
`random_steps`, the scripted relocation expert where it intervenes), each
transition goes to the ring of the task that owned it (a masked insert per
ring), and both learners update on their own rings. Episode statistics per
task stay on the device.

A learner updates once its ring holds max(training_starts, batch_size *
utd_ratio) rows in all (the JAX package's gate on the total, which lets
the zero rows of streams that have not served the task yet into early
batches). A ring's size never falls, so the gate can only open: the loop
reads the ring's total on the host until its gate opens and never again,
and from then on an iteration waits for nothing. With demos (demo_fraction
> 0, read as a flag as in the JAX package) every batch is `sample_mixed`'s:
half from the online ring, half from the task's routed demo ring, whose
buffer is given to `init_fn`.

Data parallelism (`dp`, a `distributed.sharding.DataParallel`; the carry
cut by `shard_chained_carry`): as in `training/loop.py`, each rank steps its
share of the chained envs and keeps their streams of both routed rings,
draws at the global shapes and keeps its rows, and both learners average
their gradients over the ranks. The episode statistics and both rings'
row counts are summed over the ranks in one all-reduce an iteration, and
each learner's gate reads the summed count, so every rank opens it on the
same iteration (a rank-local gate would send one rank alone into the
gradient all-reduce).

The isolated two-policy program, `make_fwbw_loop` (`TaskCarry`,
`FwBwCarry`): two `BinRelocationEnv` batches, one per task, each stepped by
its own policy (with its own relocation expert) into its own ring of the
one buffer spec, each learner updating on its own ring once that ring holds
max(training_starts, batch_size * utd_ratio) rows; `evaluate_chained` runs
the forward policy to success, freezes each env there, then hands the
physical state to the backward policy with only the episode clock reset.
Under data parallelism (`dp`; `shard_fwbw_carry`) each task's envs and
streams are split over the ranks as the loop's are.

The chained loop keeps a T = 1 stack: the JAX package's `make_chained_loop`
has no frame-stack history (a longer stack raises here).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBufferState, _map2
from serl_tpu_torch.distributed.sharding import local
from serl_tpu_torch.envs.chained_bin import ChainedBinEnv, ChainedState, where_chained
from serl_tpu_torch.envs.panda_pick import _where, flatten_obs, where_state
from serl_tpu_torch.envs.scripted_expert import relocation_expert_action
from serl_tpu_torch.envs.tasks import BinRelocationEnv
from serl_tpu_torch.envs.wrappers import add_stack_axis, serl_obs
from serl_tpu_torch.training.loop import INTERVENTION_MODES, _generator, intervention_probability

TASKS = ("fw", "bw")


class FwBwConfig(NamedTuple):
    envs_per_task: int = 8  # the chained batch is twice this
    batch_size: int = 256
    utd_ratio: int = 4
    updates_per_iter: int = 1
    training_starts: int = 1000
    random_steps: int = 1000
    buffer_capacity: int = 100_000
    demo_fraction: float = 0.0  # > 0: half-demo batches (a flag, not a fraction)
    # the relocation expert overrides the policy and its action is stored:
    # "step", "episode" or "rescue", as in training/loop.py::LoopConfig
    intervention_prob: float = 0.0
    intervention_mode: str = "step"
    intervention_decay_steps: Optional[int] = None  # linear decay to 0 over these env steps
    intervention_min_prob: float = 0.0  # the decayed probability's floor


class TaskCarry(NamedTuple):
    """One task's share of the isolated program's carry."""

    agent: SACAgent
    env_states: Any
    obs: Any  # flat (n, 13), or the SERL pixel dict
    rb_state: ReplayBufferState
    demo_state: Optional[ReplayBufferState]
    ep_return: torch.Tensor  # (n,)
    ep_count: torch.Tensor  # () int32
    ret_sum: torch.Tensor  # ()
    succ_sum: torch.Tensor  # ()
    intervening: torch.Tensor  # (n,) bool: the expert owns this env's episode


class FwBwCarry(NamedTuple):
    fw: TaskCarry
    bw: TaskCarry
    rng: torch.Generator  # on the envs' device
    env_steps: int  # total transitions collected (both tasks)


def make_fwbw_loop(fw_env: BinRelocationEnv, bw_env: BinRelocationEnv, rb, config: FwBwConfig,
                   dp=None):
    """Returns (init_fn, run_chunk) of the isolated dual-policy program.

    init_fn(fw_agent, bw_agent, rng, fw_demo=None, bw_demo=None, demo_rb=None)
    -> FwBwCarry (at the global size; `rng` a torch.Generator on the envs'
    device or an int seed; fw_demo / bw_demo demo rings of the buffer
    `demo_rb`, this program's `rb` unless given); run_chunk(carry, num_iters)
    -> (carry, metrics of (num_iters,) tensors) with the JAX package's
    names: env_steps, and per task "fw/" and "bw/" reward_mean, critic_loss,
    ep_count, ret_sum, succ_sum. `rb` is the `ReplayBuffer` spec of both
    rings; each task's ring has a stream per env of its batch.

    Each iteration steps the forward task, then the backward one: the
    uniform random actions (before `random_steps`) or the policy's, the
    relocation expert toward the task's bin where it intervenes (its action
    stored), `step_auto_reset`, the insert (each row's episode id from the
    state after the step, as the JAX package takes it), the statistics, then
    the task's learner. Its draws come from the one generator in that order:
    random actions or policy noise, the intervention draw, the env's reset,
    the samples and updates, and in "episode" mode the ended episodes'
    ownership draws. Under data parallelism (`dp`, the carry cut by
    `shard_fwbw_carry`) each draw is taken at its global shape and the rank
    keeps its rows; the statistics are summed over the ranks."""
    if config.intervention_mode not in INTERVENTION_MODES:
        raise ValueError(f"intervention_mode must be 'step', 'episode' or 'rescue', got "
                         f"{config.intervention_mode!r}")
    n = config.envs_per_task
    pixel_keys = rb.image_keys
    if pixel_keys and rb.num_stack > 1:
        raise ValueError("the fwbw program acts on one frame: give it a ring with num_stack == 1")
    device = fw_env.device
    mode = config.intervention_mode
    intervenes = config.intervention_prob > 0.0
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio)
    rows = config.batch_size * config.utd_ratio
    env_index = torch.arange(n, dtype=torch.int32, device=device)
    demo = {"rb": None}
    step_kw = {} if dp is None else {"dp": dp}

    def to_agent_obs(obs):
        return add_stack_axis(obs, pixel_keys) if pixel_keys else obs

    def draw(g, p: float) -> torch.Tensor:
        return torch.rand((n,), generator=g, device=device) < p

    def init_task(env, agent, g, demo_state) -> TaskCarry:
        env_states, obs = env.reset(n, g)
        intervening = (draw(g, config.intervention_prob) if mode == "episode"
                       else torch.zeros((n,), dtype=torch.bool, device=device))
        zero = torch.zeros((), device=device)
        return TaskCarry(agent=agent, env_states=env_states, obs=_to_obs(obs, bool(pixel_keys)),
                         rb_state=rb.init_state(streams=n), demo_state=demo_state,
                         ep_return=torch.zeros((n,), device=device),
                         ep_count=torch.zeros((), dtype=torch.int32, device=device),
                         ret_sum=zero, succ_sum=zero.clone(), intervening=intervening)

    def init_fn(fw_agent, bw_agent, rng, fw_demo=None, bw_demo=None, demo_rb=None):
        demo["rb"] = demo_rb if demo_rb is not None else rb
        g = _generator(rng, device)
        fw = init_task(fw_env, fw_agent, g, fw_demo)
        bw = init_task(bw_env, bw_agent, g, bw_demo)
        return FwBwCarry(fw=fw, bw=bw, rng=g, env_steps=0)

    def step_task(env, tc: TaskCarry, env_steps: int, g):
        if env_steps < config.random_steps:
            actions = local(torch.rand((n, env.ACTION_DIM), generator=g, device=device),
                            dp) * 2.0 - 1.0
        else:
            noise = local(torch.randn((n, env.ACTION_DIM), generator=g, device=device), dp)
            actions = tc.agent.sample_actions(to_agent_obs(tc.obs), noise=noise)
        intervening = tc.intervening
        if intervenes:
            p = intervention_probability(config, env_steps)
            expert = relocation_expert_action(tc.env_states, env.target_bin(),
                                              env.config.action_scale)
            if mode == "episode":
                intervene = intervening
            else:
                intervene = local(draw(g, p), dp)
                if mode == "rescue":
                    intervene = intervening = intervening | intervene
            actions = torch.where(intervene[:, None], expert, actions)
        env_states, next_obs_d, rewards, dones, info = env.step_auto_reset(
            tc.env_states, actions, generator=g, final_obs=rb.store_next_obs, **step_kw)
        transitions = {"observations": tc.obs, "actions": actions, "rewards": rewards,
                       "masks": 1.0 - dones, "dones": dones}
        if rb.store_next_obs:
            transitions["next_observations"] = _to_obs(info["final_obs"], bool(pixel_keys))
        # the episode ids of the state after the step (an ended episode's
        # last row takes the next episode's id), as the JAX program takes them
        ep_ids = env_states.ep_id * n + local(env_index, dp)
        rb_state = rb.insert(tc.rb_state, transitions, ep_ids)

        done_mask = dones > 0.5
        ep_return = tc.ep_return + rewards
        done_count = done_mask.sum()
        ret_done = torch.where(done_mask, ep_return, 0.0).sum()
        succ_done = torch.where(done_mask, info["success"], 0.0).sum()
        if dp is None:
            reward_mean = rewards.mean()
        else:
            sums = dp.all_reduce_sum_(torch.stack([rewards.sum(), done_count.to(torch.float32),
                                                   ret_done, succ_done]))
            reward_mean, done_count, ret_done, succ_done = sums[0] / n, *sums[1:]
        ep_count = tc.ep_count + done_count.to(torch.int32)
        ret_sum = tc.ret_sum + ret_done
        succ_sum = tc.succ_sum + succ_done
        ep_return = torch.where(done_mask, 0.0, ep_return)
        if intervenes and mode == "episode":
            intervening = torch.where(done_mask, local(draw(g, p), dp), intervening)
        elif mode == "rescue":
            intervening = intervening & ~done_mask

        # the learner, once the ring holds its rows (host integers: every
        # rank opens the gate on the same iteration)
        if rb_state.size * n >= threshold:
            losses = []
            for _ in range(config.updates_per_iter):
                if config.demo_fraction > 0.0 and tc.demo_state is not None:
                    batch = rb.sample_mixed(rb_state, tc.demo_state, rows, generator=g,
                                            buffer_b=demo["rb"], dp=dp)
                else:
                    batch = rb.sample(rb_state, rows, generator=g, dp=dp)
                _, info_u = tc.agent.update_high_utd(batch, utd_ratio=config.utd_ratio,
                                                     generator=g)
                losses.append(info_u["critic"]["critic_loss"])
            critic_loss = torch.stack(losses).mean()
        else:
            critic_loss = torch.zeros((), device=device)  # no update ran
        new_tc = tc._replace(env_states=env_states, obs=_to_obs(next_obs_d, bool(pixel_keys)),
                             rb_state=rb_state, ep_return=ep_return, ep_count=ep_count,
                             ret_sum=ret_sum, succ_sum=succ_sum, intervening=intervening)
        return new_tc, {"reward_mean": reward_mean, "critic_loss": critic_loss,
                        "ep_count": ep_count, "ret_sum": ret_sum, "succ_sum": succ_sum}

    def iter_body(carry: FwBwCarry):
        g = carry.rng
        fw, fw_m = step_task(fw_env, carry.fw, carry.env_steps, g)
        bw, bw_m = step_task(bw_env, carry.bw, carry.env_steps, g)
        env_steps = carry.env_steps + 2 * n
        metrics = {"env_steps": torch.tensor(env_steps, dtype=torch.int32),
                   **{f"fw/{k}": v for k, v in fw_m.items()},
                   **{f"bw/{k}": v for k, v in bw_m.items()}}
        return carry._replace(fw=fw, bw=bw, env_steps=env_steps), metrics

    def run_chunk(carry: FwBwCarry, num_iters: int):
        history = []
        for _ in range(num_iters):
            carry, metrics = iter_body(carry)
            history.append(metrics)
        stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]} if history else {}
        return carry, stacked

    return init_fn, run_chunk


@torch.no_grad()
def evaluate_chained(fw_env: BinRelocationEnv, bw_env: BinRelocationEnv, fw_agent, bw_agent,
                     rng=None, num_episodes: int = 16, max_steps: int = 100, pixel_keys=(),
                     reset_draws=None) -> Dict[str, float]:
    """The isolated program's round trips: `num_episodes` envs run the
    forward policy for `max_steps` steps, each frozen at its first success
    (the task graph's switch moment); then the physical state goes to the
    backward policy with no reset, only the episode clock set to 0, for
    `max_steps` more. A backward-only diagnostic runs the backward policy
    from its own fresh reset. Argmax actions. Both resets take the same
    draws (`reset_draws`, or one draw from `rng`), as the JAX function
    resets both from the same keys. Returns eval/fw_success,
    eval/bw_success (the diagnostic), eval/bw_success_given_fw and
    eval/round_trip_success."""
    pixel = bool(tuple(pixel_keys))

    def obs_fn(o):
        return add_stack_axis(serl_obs(o), tuple(pixel_keys)) if pixel else flatten_obs(o)

    n = num_episodes
    device = fw_env.device
    if reset_draws is None:
        reset_draws = fw_env.sample_reset_draws(n, _generator(rng, device))

    # the backward-only diagnostic, from its own clean reset
    states, obs = bw_env.reset(n, draws=reset_draws)
    bw_solo = torch.zeros((n,), device=device)
    for _ in range(max_steps):
        states, obs, _, _, info = bw_env.step(states, bw_agent.sample_actions(obs_fn(obs),
                                                                              argmax=True))
        bw_solo = torch.maximum(bw_solo, info["success"])

    states, obs = fw_env.reset(n, draws=reset_draws)
    fw_succ = torch.zeros((n,), device=device)
    for _ in range(max_steps):
        new_states, new_obs, _, _, info = fw_env.step(
            states, fw_agent.sample_actions(obs_fn(obs), argmax=True))
        # an env stays frozen at its first success: stepping on would let the
        # forward policy disturb the delivered cube before the hand-over
        frozen = fw_succ > 0.5
        states = where_state(frozen, states, new_states)
        obs = _map2(lambda a, b: _where(frozen, a, b), obs, new_obs)
        fw_succ = torch.maximum(fw_succ, info["success"])

    # the hand-over: the same physical state, the backward task, the clock reset
    states = states._replace(t=torch.zeros_like(states.t))
    obs = bw_env._obs(states)
    bw_succ = torch.zeros((n,), device=device)
    for _ in range(max_steps):
        states, obs, _, _, info = bw_env.step(states, bw_agent.sample_actions(obs_fn(obs),
                                                                              argmax=True))
        bw_succ = torch.maximum(bw_succ, info["success"])
    return {"eval/fw_success": float(fw_succ.mean()),
            "eval/bw_success": float(bw_solo.mean()),
            "eval/bw_success_given_fw": float((bw_succ * fw_succ).sum()
                                              / torch.clamp(fw_succ.sum(), min=1.0)),
            "eval/round_trip_success": float((fw_succ * bw_succ).mean())}


class ChainedCarry(NamedTuple):
    fw_agent: SACAgent
    bw_agent: SACAgent
    env_states: ChainedState
    obs: Any  # flat (N, 13), or the SERL pixel dict
    fw_rb: Any  # RoutedBufferState
    bw_rb: Any
    fw_demo: Optional[Any]
    bw_demo: Optional[Any]
    rng: torch.Generator  # on the env's device
    env_steps: int  # total transitions collected
    ep_return: torch.Tensor  # (N,)
    ep_count: torch.Tensor  # (2,) int32 completed episodes per task
    ret_sum: torch.Tensor  # (2,)
    succ_sum: torch.Tensor  # (2,) driving success (the classifiers' where set)
    succ_gt_sum: torch.Tensor  # (2,) ground-truth success
    switch_sum: torch.Tensor  # () completed task flips
    intervening: torch.Tensor  # (N,) bool
    training: Tuple[bool, bool]  # each learner's gate, latched open


def _to_obs(obs_dict, pixel: bool):
    return serl_obs(obs_dict) if pixel else flatten_obs(obs_dict)


def chained_expert_action(env: ChainedBinEnv, states: ChainedState) -> torch.Tensor:
    """The relocation expert's (N, 7) action toward each env's target bin."""
    return relocation_expert_action(states.env, env.target_bins(states.task),
                                    env.fw.config.action_scale)


def _per_task(values: torch.Tensor, task: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Sum of `values` over the done envs, split by task: (2,)."""
    sel = torch.where(done, values, torch.zeros_like(values))
    return torch.stack([torch.where(task == t, sel, torch.zeros_like(sel)).sum() for t in (0, 1)])


def make_chained_loop(env: ChainedBinEnv, rb, config: FwBwConfig, dp=None):
    """Returns (init_fn, run_chunk); with `dp`, run_chunk takes this rank's
    share (`shard_chained_carry`) of init_fn's global carry.

    init_fn(fw_agent, bw_agent, rng, fw_demo=None, bw_demo=None, demo_rb=None)
    -> ChainedCarry, where `rng` is a torch.Generator on the env's device or
    an int seed, and fw_demo / bw_demo routed demo rings of the buffer
    `demo_rb`; run_chunk(carry, num_iters) -> (carry, metrics of
    (num_iters, ...) tensors) with the JAX package's metric names (and each
    learner's actor_loss). `rb` is the `RoutedReplayBuffer` spec of both
    online rings."""
    if config.intervention_mode not in INTERVENTION_MODES:
        raise ValueError(f"intervention_mode must be 'step', 'episode' or 'rescue', got "
                         f"{config.intervention_mode!r}")
    n = config.envs_per_task * 2
    pixel_keys = rb.image_keys
    if pixel_keys and rb.num_stack > 1:
        raise ValueError("the chained loop acts on one frame (the JAX package's has no "
                         "frame-stack history): give it a ring with num_stack == 1")
    device = env.device
    mode = config.intervention_mode
    intervenes = config.intervention_prob > 0.0
    threshold = max(config.training_starts, config.batch_size * config.utd_ratio, 1)
    rows = config.batch_size * config.utd_ratio
    env_index = torch.arange(n, dtype=torch.int32, device=device)
    demo = {"rb": None}  # the demo rings' buffer, taken at init_fn
    step_kw = {} if dp is None else {"dp": dp}

    def to_agent_obs(obs):
        return add_stack_axis(obs, pixel_keys) if pixel_keys else obs

    def draw(g, p: float) -> torch.Tensor:
        return torch.rand((n,), generator=g, device=device) < p

    def init_fn(fw_agent, bw_agent, rng, fw_demo=None, bw_demo=None, demo_rb=None):
        demo["rb"] = demo_rb
        g = _generator(rng, device)
        env_states, obs = env.reset(n, g)
        intervening = (draw(g, config.intervention_prob) if mode == "episode"
                       else torch.zeros((n,), dtype=torch.bool, device=device))
        zeros2 = torch.zeros((2,), device=device)
        return ChainedCarry(
            fw_agent=fw_agent, bw_agent=bw_agent, env_states=env_states,
            obs=_to_obs(obs, bool(pixel_keys)),
            fw_rb=rb.init_state(streams=n), bw_rb=rb.init_state(streams=n),
            fw_demo=fw_demo, bw_demo=bw_demo, rng=g, env_steps=0,
            ep_return=torch.zeros((n,), device=device),
            ep_count=torch.zeros((2,), dtype=torch.int32, device=device),
            ret_sum=zeros2, succ_sum=zeros2.clone(), succ_gt_sum=zeros2.clone(),
            switch_sum=torch.zeros((), device=device), intervening=intervening,
            training=(False, False))

    def learner(agent, rb_state, demo_state, g) -> Dict[str, torch.Tensor]:
        infos = []
        for _ in range(config.updates_per_iter):
            if config.demo_fraction > 0.0 and demo_state is not None:
                batch = rb.sample_mixed(rb_state, demo_state, rows, generator=g,
                                        buffer_b=demo["rb"], dp=dp)
            else:
                batch = rb.sample(rb_state, rows, generator=g, dp=dp)
            _, info = agent.update_high_utd(batch, utd_ratio=config.utd_ratio, generator=g)
            infos.append(info)
        return {"critic_loss": torch.stack([i["critic"]["critic_loss"] for i in infos]).mean(),
                "actor_loss": torch.stack([i["actor"]["actor_loss"] for i in infos]).mean()}

    def iter_body(carry: ChainedCarry):
        g = carry.rng
        task = carry.env_states.task
        is_fw = (task == 0)[:, None]

        # ---- actor: one step for every env, by its task's policy ----
        if carry.env_steps < config.random_steps:
            actions = local(torch.rand((n, env.ACTION_DIM), generator=g, device=device),
                            dp) * 2.0 - 1.0
        else:
            agent_obs = to_agent_obs(carry.obs)
            noise = [local(torch.randn((n, env.ACTION_DIM), generator=g, device=device), dp)
                     for _ in TASKS]
            actions = torch.where(is_fw, carry.fw_agent.sample_actions(agent_obs, noise=noise[0]),
                                  carry.bw_agent.sample_actions(agent_obs, noise=noise[1]))
        intervening = carry.intervening
        if intervenes:
            p = intervention_probability(config, carry.env_steps)
            if mode == "episode":
                intervene = intervening
            elif mode == "rescue":
                intervene = intervening = intervening | local(draw(g, p), dp)
            else:
                intervene = local(draw(g, p), dp)
            actions = torch.where(intervene[:, None], chained_expert_action(env, carry.env_states),
                                  actions)
        env_states, next_obs_d, rewards, dones, info = env.step_auto_reset(
            carry.env_states, actions, generator=g, final_obs=rb.store_next_obs, **step_kw)
        next_obs = _to_obs(next_obs_d, bool(pixel_keys))

        transitions = {"observations": carry.obs, "actions": actions, "rewards": rewards,
                       "masks": 1.0 - dones, "dones": dones}
        if rb.store_next_obs:
            transitions["next_observations"] = _to_obs(info["final_obs"], bool(pixel_keys))
        ep_ids = carry.env_states.env.ep_id * n + local(env_index, dp)
        fw_rb = rb.insert(carry.fw_rb, transitions, ep_ids, mask=task == 0)
        bw_rb = rb.insert(carry.bw_rb, transitions, ep_ids, mask=task == 1)

        # ---- episode statistics, per task (summed over the ranks) ----
        done_mask = dones > 0.5
        ep_return = carry.ep_return + rewards
        done_count = torch.stack([((task == t) & done_mask).sum() for t in (0, 1)])
        ret_done = _per_task(ep_return, task, done_mask)
        succ_done = _per_task(info["success"], task, done_mask)
        succ_gt_done = _per_task(info["success_gt"], task, done_mask)
        switched = info["switched"].sum()
        ring_rows = torch.stack([fw_rb.size.sum(), bw_rb.size.sum()])
        if dp is None:
            reward_mean = rewards.mean()
        else:
            f32 = torch.float32
            sums = dp.all_reduce_sum_(torch.cat([
                rewards.sum()[None], done_count.to(f32), ret_done, succ_done, succ_gt_done,
                switched.to(f32)[None], ring_rows.to(f32)]))
            reward_mean = sums[0] / n
            done_count, ret_done, succ_done, succ_gt_done = sums[1:3], sums[3:5], sums[5:7], sums[7:9]
            switched, ring_rows = sums[9], sums[10:12].to(torch.int64)
        ep_count = carry.ep_count + done_count.to(torch.int32)
        ret_sum = carry.ret_sum + ret_done
        succ_sum = carry.succ_sum + succ_done
        succ_gt_sum = carry.succ_gt_sum + succ_gt_done
        switch_sum = carry.switch_sum + switched
        ep_return = torch.where(done_mask, 0.0, ep_return)
        if intervenes and mode == "episode":
            intervening = torch.where(done_mask, local(draw(g, p), dp), intervening)
        elif mode == "rescue":
            intervening = intervening & ~done_mask
        env_steps = carry.env_steps + n

        # ---- learners: each on its own ring once its gate has opened (on
        # the rows of all ranks' streams, read on the host until it opens) ----
        training = tuple(open_ or int(rows_) >= threshold
                         for open_, rows_ in zip(carry.training, ring_rows))
        metrics = {"env_steps": torch.tensor(env_steps, dtype=torch.int32),
                   "reward_mean": reward_mean}
        for name, on, agent, rb_state, demo_state in zip(
                TASKS, training, (carry.fw_agent, carry.bw_agent), (fw_rb, bw_rb),
                (carry.fw_demo, carry.bw_demo)):
            if on:
                out = learner(agent, rb_state, demo_state, g)
            else:  # no update ran
                out = dict.fromkeys(("critic_loss", "actor_loss"), torch.zeros((), device=device))
            metrics.update({f"{name}/{k}": v for k, v in out.items()})
        metrics.update(ep_count=ep_count, ret_sum=ret_sum, succ_sum=succ_sum,
                       succ_gt_sum=succ_gt_sum, switch_sum=switch_sum,
                       fw_rows=ring_rows[0], bw_rows=ring_rows[1])
        new_carry = carry._replace(
            env_states=env_states, obs=next_obs, fw_rb=fw_rb, bw_rb=bw_rb, env_steps=env_steps,
            ep_return=ep_return, ep_count=ep_count, ret_sum=ret_sum, succ_sum=succ_sum,
            succ_gt_sum=succ_gt_sum, switch_sum=switch_sum, intervening=intervening,
            training=training)
        return new_carry, metrics

    def run_chunk(carry: ChainedCarry, num_iters: int):
        history = []
        for _ in range(num_iters):
            carry, metrics = iter_body(carry)
            history.append(metrics)
        stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]} if history else {}
        return carry, stacked

    return init_fn, run_chunk


def collect_chained_demos(env: ChainedBinEnv, rb, num_streams: int, steps: int, rng=None,
                          pixel_obs: bool = False):
    """Scripted-expert demos collected in the chained env: the relocation
    expert keeps moving the cube while the task graph flips at each
    delivery, so the demos hold the hand-over states natively. Returns
    (fw_state, bw_state, stats): two routed rings of `rb` with `num_streams`
    streams, each transition in the ring of the task active at its step;
    stats holds the episodes, their ground-truth success rate and each
    ring's rows."""
    g = _generator(rng, env.device)
    fw_state, bw_state = rb.init_state(streams=num_streams), rb.init_state(streams=num_streams)
    index = torch.arange(num_streams, dtype=torch.int32, device=env.device)
    states, obs = env.reset(num_streams, g)
    obs = _to_obs(obs, pixel_obs)
    succ = torch.zeros((), device=env.device)
    eps = torch.zeros((), dtype=torch.int64, device=env.device)
    for _ in range(steps):
        task = states.task
        actions = chained_expert_action(env, states)
        new_states, next_obs_d, rew, done, info = env.step_auto_reset(
            states, actions, generator=g, final_obs=rb.store_next_obs)
        tr = {"observations": obs, "actions": actions, "rewards": rew, "masks": 1.0 - done,
              "dones": done}
        if rb.store_next_obs:
            tr["next_observations"] = _to_obs(info["final_obs"], pixel_obs)
        ep_ids = states.env.ep_id * num_streams + index
        fw_state = rb.insert(fw_state, tr, ep_ids, mask=task == 0)
        bw_state = rb.insert(bw_state, tr, ep_ids, mask=task == 1)
        ended = done > 0.5
        succ = succ + torch.where(ended, info["success_gt"], 0.0).sum()
        eps = eps + ended.sum()
        states, obs = new_states, _to_obs(next_obs_d, pixel_obs)
    episodes = float(eps)
    stats = {"episodes": episodes, "success_rate": float(succ) / max(episodes, 1.0),
             "fw_rows": int(fw_state.size.sum()), "bw_rows": int(bw_state.size.sum())}
    return fw_state, bw_state, stats


@torch.no_grad()
def evaluate_chained_env(env: ChainedBinEnv, fw_agent, bw_agent, rng=None,
                         num_episodes: int = 32, pixel_keys=()) -> Dict[str, float]:
    """Round trips through the chained env, the reference's switch
    semantics: each of `num_episodes` chains starts on the forward task;
    when it succeeds the episode ends, the arm resets to the backward
    task's pose and the cube stays, then the backward policy runs. A chain
    freezes once its two episodes are spent. Then a backward-only
    diagnostic: one clean backward episode per chain from a fresh reset.
    Argmax actions; `env` must run on the ground truth with no fresh
    resets. Returns eval/fw_success, eval/bw_success (the diagnostic),
    eval/bw_success_given_fw and eval/round_trip_success."""
    if env.fresh_reset_prob != 0.0:
        raise ValueError("the evaluation env must not fresh-reset")
    if env.classifier_fns is not None:
        raise ValueError("the evaluation runs on the ground truth (no classifier_fns)")
    pixel_keys = tuple(pixel_keys)
    obs_fn = (lambda o: add_stack_axis(o, pixel_keys)) if pixel_keys else (lambda o: o)
    max_steps = env.time_limit_steps
    g = _generator(rng, env.device)
    n = num_episodes

    states, obs_d = env.reset(n, g, task=0)
    obs = _to_obs(obs_d, bool(pixel_keys))
    eps_done = torch.zeros((n,), dtype=torch.int32, device=env.device)
    fw_succ = torch.zeros((n,), device=env.device)
    rt_succ = torch.zeros((n,), device=env.device)
    for _ in range(2 * max_steps):
        aobs = obs_fn(obs)
        actions = torch.where((states.task == 0)[:, None],
                              fw_agent.sample_actions(aobs, argmax=True),
                              bw_agent.sample_actions(aobs, argmax=True))
        new_states, new_obs_d, _, d, info = env.step_auto_reset(states, actions, generator=g,
                                                               final_obs=False)
        new_obs = _to_obs(new_obs_d, bool(pixel_keys))
        done = d > 0.5
        sw = info["switched"].to(torch.float32)
        # episode 0 is the forward attempt; episode 1, after a switch, the backward one
        fw_succ = torch.where((eps_done == 0) & done, sw, fw_succ)
        rt_succ = torch.where((eps_done == 1) & done, sw * (fw_succ > 0.5), rt_succ)
        frozen = eps_done >= 2
        states = where_chained(~frozen, states, new_states)
        obs = _map2(lambda a, b: _where(~frozen, a, b), obs, new_obs)
        eps_done = torch.where(frozen, eps_done, eps_done + done.to(torch.int32))

    # the backward-only diagnostic: one clean backward episode per chain
    bw_start, bw_obs_d = env.reset(n, g, task=1)
    states, obs = bw_start, _to_obs(bw_obs_d, bool(pixel_keys))
    bw_solo = torch.zeros((n,), device=env.device)
    for _ in range(max_steps):
        actions = bw_agent.sample_actions(obs_fn(obs), argmax=True)
        new_states, new_obs_d, _, d, info = env.step_auto_reset(states, actions, generator=g,
                                                               final_obs=False)
        bw_solo = torch.maximum(bw_solo, torch.where(d > 0.5, info["success_gt"], 0.0))
        frozen = states.env.ep_id > bw_start.env.ep_id
        states = where_chained(~frozen, states, new_states)
        obs = _map2(lambda a, b: _where(~frozen, a, b), obs, _to_obs(new_obs_d, bool(pixel_keys)))
    fw_total = fw_succ.sum()
    return {"eval/fw_success": float(fw_succ.mean()),
            "eval/bw_success": float(bw_solo.mean()),
            "eval/bw_success_given_fw": float(rt_succ.sum() / torch.clamp(fw_total, min=1.0)),
            "eval/round_trip_success": float(rt_succ.mean())}

