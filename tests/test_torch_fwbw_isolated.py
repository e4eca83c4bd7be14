"""The isolated fwbw program, its evaluation and its data-parallel layout
against serl_tpu's, on the CPU.

- `make_fwbw_loop` over two `BinRelocationEnv` batches (2 envs a task, the
  time limit cut to 3 steps, small agents: 32-wide MLPs, 4 critics), both
  frameworks' control step replaced by the identity (as
  tests/test_torch_tasks.py does: the physics is held elsewhere; here the
  program's bookkeeping is): every reset takes JAX's draws from its key
  chain, and each iteration is replayed task by task through JAX's vmapped
  `step_auto_reset` from the port's own state with the actions the port
  stored: each ring's new row (observations and next_observations to 1e-5,
  the Euler angles modulo 2 pi to 1e-3, rewards to 1e-5, dones and masks
  exactly, the episode ids of the state after the step, as JAX takes
  them), the next clocks and ids exactly, the per-task sums; each learner's
  first update through JAX's update_high_utd with the same draws (critic
  loss 1e-5 relative, params and targets 1e-4). With the expert always
  intervening, the stored actions are JAX's relocation expert's (1e-3).
- `evaluate_chained` with scripted agents (fixed tanh maps of the flat
  observation) and a scripted success (a parity of the mocap's x position,
  patched into both frameworks), from JAX's reset draws: every metric
  equal; the frozen envs, the hand-over and the backward-only diagnostic
  all take part.
- `shard_fwbw_carry` on 2 gloo ranks (spawned once, real physics, 4 envs a
  rank): each rank holds its half of each task's envs and streams; while
  the actions are random the merged state equals the one-rank run bit for
  bit; digests equal on every rank after each segment; collectives as
  derived. The same spawn runs `tools/scaling_analysis.py`'s analysis of
  the state and pixel programs: no collective in a replay insert or sample,
  one all-to-all an update, no all-gather in an iteration.
"""

import collections
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.envs.scripted_expert import relocation_expert_action as jexpert
from serl_tpu.training import fwbw as jfwbw
from serl_tpu_torch.distributed import sharding
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.examples.dryrun_multichip import launch
from serl_tpu_torch.tools import scaling_analysis
from serl_tpu_torch.training import fwbw
from serl_tpu_torch.training.launcher import make_state_replay_buffer
from serl_tpu_torch.utils.jax_params import train_state_to_jax_layout
from tests import torch_dp
from tests._ports import next_port_pair
from tests.test_torch_fwbw import ACT, LIMIT, OBS, _assert_obs, _small_agent
from tests.test_torch_learner import (
    _kwargs,
    assert_trees_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.torch_pose_jax import jax_reset_draws, to_jax

EPT, E = 2, 4
TASKS = ("fw", "bw")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _no_physics(monkeypatch):
    monkeypatch.setattr(engine, "control_step", lambda p, obstacles=None: p)
    monkeypatch.setattr(jengine, "control_step", lambda p, obstacles=None: p)


def _envs(limit=LIMIT):
    port = [tasks.BinRelocationEnv(task_id=t, device="cpu") for t in (0, 1)]
    jenvs = [jtasks.BinRelocationEnv(task_id=t) for t in (0, 1)]
    for e in port + jenvs:
        e.config = e.config._replace(time_limit_steps=limit)
    return port, jenvs


class _KeyChain:
    """JAX's per-env keys for one task's env, mirrored: each reset's draws
    from them, and the key each env carries on (a reset's k_next)."""

    def __init__(self, env, keys, monkeypatch):
        self.env, self.pending, self.rng = env, keys, None
        reset, step = env.reset, env.step_auto_reset

        def reset_(n, generator=None, draws=None):
            self.rng = jax.vmap(lambda k: jax.random.split(k, 4)[3])(self.pending)
            return reset(n, draws=jax_reset_draws(self.pending, env.config, jitter=True))

        def step_(state, action, generator=None, draws=None, final_obs=True, dp=None):
            self.before_rng = self.rng
            chain = jax.vmap(jax.random.fold_in)(self.rng, jnp.asarray(state.ep_id.numpy()))
            out = step(state, action, draws=jax_reset_draws(chain, env.config, jitter=True),
                       final_obs=final_obs)
            k_next = jax.vmap(lambda k: jax.random.split(k, 4)[3])(chain)
            done = jnp.asarray(out[3].numpy() > 0.5)
            self.rng = jnp.where(done[:, None], k_next, self.rng)
            return out

        monkeypatch.setattr(env, "reset", reset_)
        monkeypatch.setattr(env, "step_auto_reset", step_)


def _spy_updates(agents, monkeypatch):
    records, keys = [], iter(jax.random.split(jax.random.PRNGKey(11), 64))
    for name, agent in zip(TASKS, agents):
        inner = agent.update_high_utd

        def spy(batch, *, utd_ratio, draws=None, generator=None, name=name, agent=agent,
                inner=inner):
            key = next(keys)
            rec = {"name": name, "key": key, "before": train_state_to_jax_layout(agent),
                   "batch": {k: v.numpy().copy() for k, v in batch.items()}}
            out = inner(batch, utd_ratio=utd_ratio, draws=jax_high_utd_draws(
                key, batch["rewards"].shape[0], utd_ratio, ensemble=E, action_dim=ACT))
            rec["after"], rec["info"] = train_state_to_jax_layout(agent), out[1]
            records.append(rec)
            return out

        monkeypatch.setattr(agent, "update_high_utd", spy)
    return records


def test_torch_fwbw_loop_matches_jax_step_by_step(monkeypatch):
    _no_physics(monkeypatch)
    (fw_env, bw_env), jenvs = _envs()
    chains = [_KeyChain(e, jax.random.split(jax.random.PRNGKey(3 + i), EPT), monkeypatch)
              for i, e in enumerate((fw_env, bw_env))]
    config = fwbw.FwBwConfig(envs_per_task=EPT, batch_size=4, utd_ratio=2, training_starts=8,
                             random_steps=8, buffer_capacity=EPT * 10)
    rb = make_state_replay_buffer(capacity=config.buffer_capacity, obs_dim=OBS, action_dim=ACT,
                                  device="cpu")
    agents = (_small_agent(1), _small_agent(2))
    records = _spy_updates(agents, monkeypatch)
    init_fn, run_chunk = fwbw.make_fwbw_loop(fw_env, bw_env, rb, config)
    carry = init_fn(*agents, 0)
    jauto = [jax.jit(jax.vmap(e.step_auto_reset)) for e in jenvs]
    jobs = [jax.jit(jax.vmap(lambda s, e=e: jpick.flatten_obs(e._obs(s)))) for e in jenvs]
    sums = {t: np.zeros(3) for t in TASKS}  # ep_count, ret_sum, succ_sum
    ep_return = {t: np.zeros(EPT) for t in TASKS}
    ends = 0
    for it in range(7):
        before = {t: getattr(carry, t).env_states for t in TASKS}
        carry, metrics = run_chunk(carry, 1)
        for i, t in enumerate(TASKS):
            tc = getattr(carry, t)
            slot = (tc.rb_state.insert_slot - 1) % tc.rb_state.ep_id.shape[0]
            row = {k: v[slot] for k, v in tc.rb_state.data.items()}
            js = to_jax(before[t], chains[i].before_rng)
            new, _, jr, jd, ji = jauto[i](js, jnp.asarray(row["actions"].numpy()))
            _assert_obs(row["observations"], jobs[i](js))
            _assert_obs(row["next_observations"], jpick.flatten_obs(ji["final_obs"]))
            np.testing.assert_allclose(row["rewards"].numpy(), np.asarray(jr), atol=1e-5)
            np.testing.assert_array_equal(row["dones"].numpy(), np.asarray(jd))
            np.testing.assert_array_equal(row["masks"].numpy(), 1.0 - np.asarray(jd))
            np.testing.assert_array_equal(tc.rb_state.ep_id[slot].numpy(),
                                          np.asarray(new.ep_id) * EPT + np.arange(EPT))
            np.testing.assert_array_equal(tc.env_states.t.numpy(), np.asarray(new.t))
            np.testing.assert_array_equal(tc.env_states.ep_id.numpy(), np.asarray(new.ep_id))
            done = np.asarray(jd) > 0.5
            ep_return[t] += np.asarray(jr)
            sums[t] += [done.sum(), ep_return[t][done].sum(), np.asarray(ji["success"])[done].sum()]
            ep_return[t][done] = 0.0
            ends += int(done.sum())
            for j, k in enumerate(("ep_count", "ret_sum", "succ_sum")):
                np.testing.assert_allclose(float(metrics[f"{t}/{k}"][-1]), sums[t][j], atol=1e-5)
        assert int(metrics["env_steps"][-1]) == (it + 1) * 2 * EPT
    assert ends == 4 * EPT  # two episode ends a task and env
    # each learner updated from its gate (iteration 3) on, on its own ring
    assert [r["name"] for r in records] == ["fw", "bw"] * 4
    jagent = JaxSACAgent.create_states(jax.random.PRNGKey(0), jnp.zeros((1, OBS)),
                                       jnp.zeros((1, ACT)), **_kwargs(jnp.tanh))
    for rec in records[:2]:
        batch = {k: jnp.asarray(v) for k, v in rec["batch"].items()}
        jnew, jinfo = jax_with_state(jagent, rec["before"], rec["key"]).update_high_utd(
            batch, utd_ratio=2)
        want = jax_state_np(jnew)
        for part in ("params", "target_params"):
            assert_trees_close(rec["after"][part], want[part], 1e-4, what=part)
        np.testing.assert_allclose(float(rec["info"]["critic"]["critic_loss"]),
                                   float(jinfo["critic"]["critic_loss"]), rtol=1e-5)


def test_torch_fwbw_loop_stores_the_relocation_experts_actions(monkeypatch):
    _no_physics(monkeypatch)
    (fw_env, bw_env), jenvs = _envs()
    config = fwbw.FwBwConfig(envs_per_task=EPT, batch_size=4, utd_ratio=2, training_starts=100,
                             random_steps=100, buffer_capacity=EPT * 10, intervention_prob=1.0)
    rb = make_state_replay_buffer(capacity=config.buffer_capacity, obs_dim=OBS, action_dim=ACT,
                                  device="cpu")
    init_fn, run_chunk = fwbw.make_fwbw_loop(fw_env, bw_env, rb, config)
    carry = init_fn(_small_agent(1), _small_agent(2), 0)
    for _ in range(2):
        before = {t: getattr(carry, t).env_states for t in TASKS}
        carry, _ = run_chunk(carry, 1)
        for t, jenv in zip(TASKS, jenvs):
            tc = getattr(carry, t)
            slot = (tc.rb_state.insert_slot - 1) % tc.rb_state.ep_id.shape[0]
            tgt = jnp.asarray(jenv.FW_BIN if jenv.task_id == 0 else jenv.BW_BIN)
            want = jax.vmap(lambda s: jexpert(s, tgt, jnp.asarray(jenv.config.action_scale)))(
                to_jax(before[t]))
            np.testing.assert_allclose(tc.rb_state.data["actions"][slot].numpy(),
                                       np.asarray(want), atol=1e-3)


def _jax_success(self, state):
    return ((state.physics.mocap_pos[..., 0] * 100.0) // 1.0 % 2 == 1).astype(jnp.float32)


def _torch_success(self, state):
    return ((state.physics.mocap_pos[..., 0] * 100.0) // 1.0 % 2 == 1).to(torch.float32)


W = np.random.default_rng(0).normal(size=(2, OBS, ACT)).astype(np.float32)


class _JaxLinear:
    def __init__(self, w):
        self.w = jnp.asarray(w)

    def sample_actions(self, obs, argmax=False):
        return jnp.tanh(obs @ self.w)


class _TorchLinear:
    def __init__(self, w):
        self.w = torch.from_numpy(w)

    def sample_actions(self, obs, argmax=False):
        return torch.tanh(obs @ self.w)


def test_torch_evaluate_chained_matches_jax(monkeypatch):
    _no_physics(monkeypatch)
    monkeypatch.setattr(jtasks.BinRelocationEnv, "_success", _jax_success)
    monkeypatch.setattr(tasks.BinRelocationEnv, "_success", _torch_success)
    (fw_env, bw_env), (jfw, jbw) = _envs(limit=100)
    n, steps = 6, 8
    key = jax.random.PRNGKey(9)
    # JAX's evaluate_chained jits a rollout over its agents: give it pytrees
    from flax import struct

    class JaxAgent(struct.PyTreeNode):
        w: jnp.ndarray

        def sample_actions(self, obs, argmax=False):
            return jnp.tanh(obs @ self.w)

    want = jfwbw.evaluate_chained(jfw, jbw, JaxAgent(jnp.asarray(W[0])), JaxAgent(jnp.asarray(W[1])),
                                  key, num_episodes=n, max_steps=steps)
    draws = jax_reset_draws(jax.random.split(key, n), fw_env.config, jitter=True)
    got = fwbw.evaluate_chained(fw_env, bw_env, _TorchLinear(W[0]), _TorchLinear(W[1]),
                                num_episodes=n, max_steps=steps, reset_draws=draws)
    assert got == pytest.approx(want, abs=1e-6), (got, want)
    # some chains freeze at a forward success and are handed over, some not
    assert 0 < want["eval/fw_success"] < 1 and want["eval/bw_success"] > 0


# ---------------------------------------------------------------- the layout on 2 ranks

WORLD = 2
DP_CONFIG = fwbw.FwBwConfig(envs_per_task=8, batch_size=8, utd_ratio=2, training_starts=16,
                            random_steps=32, buffer_capacity=8 * 8)
DP_SEGMENTS = [1, 3]  # both gates open in iteration 1 (16 rows a ring); random actions to 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("fwbw_iso_two"))
    one_snap = str(tmp_path_factory.mktemp("fwbw_iso_one"))
    out = {}

    def run():
        try:
            out["ranks"] = launch(torch_dp.Tasks(
                torch_dp.FwbwIsolatedRun(DP_CONFIG, DP_SEGMENTS, snap),
                scaling_analysis.Analysis(("state", "pixels"))), WORLD, "cpu", "gloo",
                port=next_port_pair(), timeout_s=300)
        except Exception as exc:  # re-raised in the test thread below
            out["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        torch.set_num_threads(1)
        one = torch_dp.run_fwbw_isolated(None, "cpu", DP_CONFIG, DP_SEGMENTS[:1], one_snap)
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    return {"ranks": out["ranks"], "one": one, "snap": snap, "one_snap": one_snap}


def test_torch_fwbw_layout_specs_and_checks():
    from serl_tpu.distributed import sharding as jsharding

    for name in ("TASK_CARRY_SPEC", "FWBW_CARRY_SPEC"):
        assert getattr(sharding, name) == getattr(jsharding, name), name
    (fw_env, bw_env), _ = _envs()
    rb = make_state_replay_buffer(capacity=6 * 4, obs_dim=OBS, action_dim=ACT, device="cpu")
    init_fn, _ = fwbw.make_fwbw_loop(fw_env, bw_env, rb, fwbw.FwBwConfig(envs_per_task=6))
    carry = init_fn(_small_agent(1), _small_agent(2), 0)
    dp = sharding.DataParallel(rank=0, world_size=WORLD, backend="gloo",
                               device=torch.device("cpu"))
    layout = sharding.fwbw_carry_layout(carry, dp)
    assert layout["rng"] == "rep" and layout["fw"]["rb_state"] == "buffer"
    with pytest.raises(ValueError, match="divide"):
        sharding.fwbw_carry_layout(carry, sharding.DataParallel(
            rank=0, world_size=4, backend="gloo", device=torch.device("cpu")))
    extra = collections.namedtuple("TaskCarry", carry.fw._fields + ("extra",))
    with pytest.raises(ValueError, match="no declared layout"):
        sharding.fwbw_carry_layout(carry._replace(fw=extra(*carry.fw, None)), dp)


def test_torch_fwbw_two_ranks_match_one(ranks):
    two = [r[0] for r in ranks["ranks"]]
    merged = torch_dp.merge_snapshots([os.path.join(ranks["snap"], f"fwbw_isolated_r{r}_s0.pt")
                                       for r in range(WORLD)])
    ref = torch.load(os.path.join(ranks["one_snap"], "fwbw_isolated_r0_s0.pt"),
                     weights_only=False)
    assert merged["agents_equal"]
    assert torch_dp.max_abs_diff(merged["env"], ref["env"]) == 0.0
    for t in TASKS:
        assert torch_dp.max_abs_diff(merged["rings"][t], ref["rings"][t]) == 0.0, t
    for a, b in zip(merged["agents"], ref["agents"]):
        assert torch_dp.max_abs_diff(a, b) == 0.0
    assert two[0]["digest"] == two[1]["digest"]
    iters = sum(DP_SEGMENTS)
    updating = iters - 1  # both gates open in iteration 1 (16 rows a ring)
    want = {"all_reduce": 2 * iters + 2 * updating * (DP_CONFIG.utd_ratio + 2),
            "all_to_all": 2 * updating, "all_gather": len(DP_SEGMENTS)}
    for r in two:
        assert {k: v["calls"] for k, v in r["collectives"].items()} == want
        assert r["env_steps"] == iters * 2 * DP_CONFIG.envs_per_task
        assert min(r["agent_steps"]) > 0
    for metric in ("fw/ep_count", "bw/reward_mean"):
        torch.testing.assert_close(two[0]["metrics"][metric], two[1]["metrics"][metric])


def test_torch_scaling_analysis_on_two_ranks(ranks):
    rows = ranks["ranks"][0][1]
    scaling_analysis.check(rows)
    assert [r["program"] for r in rows] == ["state", "pixels"]
    state = rows[0]
    assert state["envs_per_rank"] == 8 and state["collectives"]["all_to_all"]["calls"] == 1
    assert state["collectives"]["all_reduce"]["calls"] == 1 + 4 + 2  # statistics, UTD, actor+temp
    assert "| state | 2 | 8 |" in scaling_analysis.row(state)


def test_torch_pose_and_classifier_resets_keep_the_ranks_rows(monkeypatch):
    """Under data parallelism a pose env's (and the learned-reward wrapper's)
    reset draws are taken for every rank's envs: rank 1 of 2 stepping its
    half of the envs resets them as the whole batch's step resets its rows."""
    from serl_tpu_torch.envs.wrappers import ClassifierRewardEnv

    _no_physics(monkeypatch)
    dp = sharding.DataParallel(rank=1, world_size=2, backend="gloo", device=torch.device("cpu"))
    env = tasks.BinRelocationEnv(task_id=0, image_obs=True, render_size=16, device="cpu")
    env.config = env.config._replace(time_limit_steps=1)  # every env's episode ends
    wrapped = ClassifierRewardEnv(env, lambda frames: torch.zeros(frames["front"].shape[0]),
                                  "front")
    for e in (env, wrapped):
        state, _ = env.reset(4, torch.Generator().manual_seed(0))
        actions = torch.zeros((4, ACT))
        whole = e.step_auto_reset(state, actions, generator=torch.Generator().manual_seed(1),
                                  final_obs=False)[0]
        half = type(state)(*(type(x)(*(y[2:] for y in x)) if isinstance(x, tuple) else x[2:]
                             for x in state))
        mine = e.step_auto_reset(half, actions[2:], generator=torch.Generator().manual_seed(1),
                                 final_obs=False, dp=dp)[0]
        for a, b in zip(mine.physics, whole.physics):
            torch.testing.assert_close(a, b[2:], atol=0, rtol=0)
        assert torch.equal(mine.ep_id, whole.ep_id[2:]) and bool((mine.ep_id == 1).all())
