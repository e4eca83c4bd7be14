"""The port's RLPD path against serl_tpu's, on the CPU.

- `init_from_episodes`, `sample_mixed` (an even batch, whose halves'
  rows interleave, and an odd one, concatenated; halves that divide over
  their ring's streams and halves that do not) with JAX's own index draws,
  and `load_transitions`: exactly equal to JAX's (a gather is a copy).
- The loop with `demo_fraction > 0`: every contiguous UTD minibatch the
  learner takes is half demo rows, the demo rows at the odd positions.
- Interventions in the three modes at probability 0 and 1: the stored
  action is the expert's exactly when the expert intervenes; the decayed
  probability against JAX's formula.
- `run_fused` against JAX's on the same chunk metrics and evaluations: the
  log keys and values, the stop after two evaluations at or above the bar,
  the evaluation seeds; the best evaluation's params do not move with the
  training after it (checkpoints: tests/test_torch_checkpoint.py).
- `WorkloadConfig`: presets equal to JAX's field by field, and its loop
  and runner kwargs accepted by the port; the state example raises on a
  setting it does not read.
"""

import argparse
import dataclasses
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serl_tpu.training.runner as jrunner
from serl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from serl_tpu.training import config as jconfig
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.distributed.transport import TrainerConfig
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.examples import fused_sac_state_sim
from serl_tpu_torch.training import config as tconfig
from serl_tpu_torch.training import runner as trunner
from serl_tpu_torch.training.launcher import make_state_sim_experiment
from serl_tpu_torch.training.loop import (
    LoopConfig,
    evaluate,
    intervention_probability,
    make_fused_loop,
)

SLOTS, STREAMS, DEMO_STREAMS, DEMO_LEN, OBS, ACT = 6, 4, 3, 5, 5, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _example(pixels=False):
    ex = {"observations": np.zeros(OBS, np.float32), "actions": np.zeros(ACT, np.float32),
          "next_observations": np.zeros(OBS, np.float32), "rewards": np.float32(0),
          "masks": np.float32(0), "dones": np.float32(0)}
    if pixels:
        ex["observations"] = {"state": np.zeros(OBS, np.float32),
                              "front": np.zeros((3, 3, 3), np.uint8)}
    return ex


def _buffers(pixels=False, store_next_obs=True):
    ex = _example(pixels)
    jrb = JaxReplayBuffer(jax.tree.map(jnp.asarray, ex), SLOTS * STREAMS,
                          store_next_obs=store_next_obs, image_keys=("front",) if pixels else ())
    trb = ReplayBuffer(jax.tree.map(torch.as_tensor, ex), SLOTS * STREAMS,
                       store_next_obs=store_next_obs, image_keys=("front",) if pixels else (),
                       device="cpu")
    return jrb, trb


def _rows(rng, n, pixels=False):
    f = lambda *shape: rng.normal(size=(n,) + shape).astype(np.float32)
    obs = f(OBS)
    if pixels:
        obs = {"state": obs, "front": rng.integers(0, 256, (n, 3, 3, 3), dtype=np.uint8)}
    return {"observations": obs, "actions": f(ACT), "next_observations": f(OBS),
            "rewards": f(), "masks": np.ones(n, np.float32), "dones": np.zeros(n, np.float32)}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _equal(got, want, path="data"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


def _demo_states(jrb, trb, seed=1, pixels=False):
    rng = np.random.default_rng(seed)
    tr = _rows(rng, DEMO_STREAMS * DEMO_LEN, pixels)
    ep = np.repeat(np.arange(DEMO_STREAMS, dtype=np.int32), DEMO_LEN)
    return (jrb.init_from_episodes(_jax(tr), jnp.asarray(ep), DEMO_LEN),
            trb.init_from_episodes(tr, ep, DEMO_LEN))


def _online_states(jrb, trb, inserts=8, seed=0):
    """Both rings after `inserts` lockstep inserts (a wrap), episodes of 3."""
    rng = np.random.default_rng(seed)
    js, ts = jrb.init_state(STREAMS), trb.init_state(STREAMS)
    for t in range(inserts):
        tr = _rows(rng, STREAMS)
        ep = (np.arange(STREAMS) + STREAMS * (t // 3)).astype(np.int32)
        js = jrb.insert(js, _jax(tr), jnp.asarray(ep))
        ts = trb.insert(ts, _torch(tr), torch.from_numpy(ep))
    return js, ts


def _check_state(got, want):
    assert (got.insert_slot, got.size) == (int(want.insert_slot), int(want.size))
    np.testing.assert_array_equal(got.ep_id.numpy(), np.asarray(want.ep_id))
    assert got.ep_id.dtype == torch.int32
    _equal(got.data, want.data)


@pytest.mark.parametrize("pixels,store_next_obs", [(False, True), (True, False)])
def test_torch_init_from_episodes_matches_jax(pixels, store_next_obs):
    jrb, trb = _buffers(pixels, store_next_obs)
    want, got = _demo_states(jrb, trb, pixels=pixels)
    _check_state(got, want)
    assert ("next_observations" in got.data) == store_next_obs
    assert got.size == DEMO_LEN and got.ep_id.shape == (DEMO_LEN, DEMO_STREAMS)
    assert all(v.is_contiguous() for v in jax.tree.leaves(got.data))


def _jax_draws(key, state, batch, store_next_obs=True):
    """The (u, e) that JAX's `sample` draws from `key` (e None when aligned)."""
    slots, streams = state.ep_id.shape
    n_valid = max(int(state.size) if store_next_obs else int(state.size) - 1, 1)
    if batch % streams == 0:
        u = jax.random.randint(key, (batch // streams, streams), 0, n_valid)
        return torch.tensor(np.asarray(u), dtype=torch.long), None
    ks, ke = jax.random.split(key)
    u = jax.random.randint(ks, (batch,), 0, n_valid)
    e = jax.random.randint(ke, (batch,), 0, streams)
    return torch.tensor(np.asarray(u), dtype=torch.long), torch.tensor(np.asarray(e), dtype=torch.long)


# 8: the online half divides over its 4 streams, the demo half not over 3;
# 9: odd, concatenated; 12: the demo half divides, the online half not
@pytest.mark.parametrize("batch", [8, 9, 12])
def test_torch_sample_mixed_matches_jax(batch):
    jrb, trb = _buffers()
    ja, ta = _online_states(jrb, trb)
    jb, tb = _demo_states(jrb, trb)
    key = jax.random.PRNGKey(batch)
    want = jrb.sample_mixed(ja, jb, key, batch)
    ka, kb = jax.random.split(key)
    u_a, e_a = _jax_draws(ka, ja, batch // 2)
    u_b, e_b = _jax_draws(kb, jb, batch - batch // 2)
    got = trb.sample_mixed(ta, tb, batch, u_a=u_a, e_a=e_a, u_b=u_b, e_b=e_b)
    _equal(got, want, "batch")
    assert got["rewards"].shape == (batch,)
    # the rows' origins: the demo ring's rows at the odd positions of an even batch
    demo_rows = {tuple(r) for r in tb.data["observations"].reshape(-1, OBS).tolist()}
    from_demo = [tuple(r) in demo_rows for r in got["observations"].tolist()]
    half = batch // 2
    assert from_demo == ([i % 2 == 1 for i in range(batch)] if batch % 2 == 0
                         else [False] * half + [True] * (batch - half))


def test_torch_load_transitions_matches_jax():
    jrb, trb = _buffers()
    js, ts = _online_states(jrb, trb, inserts=2)
    rng = np.random.default_rng(5)
    tr = _rows(rng, 3 * STREAMS)
    tr["ep_ids"] = np.arange(3 * STREAMS, dtype=np.int32) // 2
    _check_state(trb.load_transitions(ts, tr), jrb.load_transitions(js, _jax(tr)))
    with pytest.raises(ValueError):
        trb.load_transitions(ts, {**_rows(rng, 3), "ep_ids": np.zeros(3, np.int32)})


def _small_experiment(**overrides):
    kw = dict(device="cpu", num_envs=4, training_starts=8, batch_size=4, utd_ratio=2,
              buffer_capacity=64, random_steps=8)
    kw.update(overrides)
    return make_state_sim_experiment(**kw)


def _demo_ring(rb, streams=3, length=5):
    """A demo ring whose rows are marked by reward -1 (online rewards are >= 0)."""
    n = streams * length
    tr = {"observations": torch.randn(n, 10), "actions": torch.rand(n, 4) * 2 - 1,
          "next_observations": torch.randn(n, 10), "rewards": -torch.ones(n),
          "masks": torch.ones(n), "dones": torch.zeros(n)}
    return rb.init_from_episodes(tr, torch.arange(streams).repeat_interleave(length), length)


@pytest.mark.parametrize("demo_fraction", [0.5, 0.25, 0.0])
def test_torch_loop_mixes_demo_rows_into_every_minibatch(demo_fraction):
    env, agent, rb, config, init_fn, run_chunk = _small_experiment(demo_fraction=demo_fraction)
    batches = []
    update = agent.update_high_utd

    def spy(batch, **kw):
        batches.append({k: v.clone() for k, v in batch.items()})
        return update(batch, **kw)

    agent.update_high_utd = spy
    demo_state = _demo_ring(rb)
    carry = init_fn(agent, 0, demo_state=demo_state)
    assert carry.demo_state is demo_state
    carry, metrics = run_chunk(carry, 3)
    assert carry.demo_state is demo_state
    assert len(batches) == 2  # the threshold of 8 rows is reached at the second insert
    assert (metrics["critic_loss"][1:] != 0).all()
    for batch in batches:
        demo = (batch["rewards"] == -1).tolist()
        if demo_fraction > 0:  # a flag, as in the JAX package: any fraction is half and half
            assert demo == [i % 2 == 1 for i in range(8)]
            for start in range(0, 8, config.batch_size):  # each UTD minibatch
                assert sum(demo[start:start + config.batch_size]) == config.batch_size // 2
        else:
            assert not any(demo)


MARKER = torch.tensor([0.123, -0.456, 0.789, 0.5])


@pytest.mark.parametrize("mode", ["step", "episode", "rescue"])
@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_torch_interventions_store_the_experts_action(mode, prob):
    env, agent, rb, config, *_ = _small_experiment(training_starts=10**9, random_steps=0,
                                                   intervention_prob=prob, intervention_mode=mode)
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=lambda states: MARKER)
    carry = init_fn(agent, 0)
    assert carry.intervening.dtype == torch.bool
    assert bool(carry.intervening.all()) == (mode == "episode" and prob == 1.0)
    carry, _ = run_chunk(carry, 3)
    stored = carry.rb_state.data["actions"][:3]
    if prob == 1.0:
        assert torch.equal(stored, MARKER.expand_as(stored))
        assert bool(carry.intervening.all()) == (mode != "step")
    else:
        assert not torch.isclose(stored, MARKER, atol=1e-3).all(-1).any()
        assert not carry.intervening.any()


def test_torch_default_intervening_expert_is_the_scripted_one():
    env, agent, rb, config, *_ = _small_experiment(training_starts=10**9, random_steps=0,
                                                   intervention_prob=1.0)
    init_fn, run_chunk = make_fused_loop(env, rb, config)
    carry = init_fn(agent, 0)
    want = expert_action(carry.env_states)
    carry, _ = run_chunk(carry, 1)
    torch.testing.assert_close(carry.rb_state.data["actions"][0], want, atol=0, rtol=0)


def test_torch_intervention_probability_matches_jax_formula():
    def jax_formula(cfg, env_steps):  # serl_tpu/training/loop.py::_int_prob
        p = cfg.intervention_prob
        if cfg.intervention_decay_steps:
            frac = 1.0 - jnp.asarray(env_steps, jnp.int32).astype(jnp.float32) / float(
                cfg.intervention_decay_steps)
            p = jnp.maximum(p * jnp.clip(frac, 0.0, 1.0), cfg.intervention_min_prob)
        return float(p)

    configs = [LoopConfig(intervention_prob=0.5, intervention_decay_steps=100_000,
                          intervention_min_prob=0.05),
               LoopConfig(intervention_prob=0.3, intervention_decay_steps=1000),
               LoopConfig(intervention_prob=0.4)]
    for cfg in configs:
        for steps in (0, 640, 50_016, 99_999, 150_000):
            np.testing.assert_allclose(intervention_probability(cfg, steps),
                                       jax_formula(cfg, steps), rtol=1e-6, atol=1e-8)
    assert intervention_probability(configs[0], 150_000) == 0.05


# ---------------------------------------------------------------- run_fused


class _RecordingLogger:
    def __init__(self):
        self.logs = []

    def log(self, data, step=None):
        self.logs.append((step, data))

    def close(self):
        pass


def _stub_run(runner_module, array, successes, monkeypatch, **kwargs):
    """Run `runner_module.run_fused` over scripted chunk metrics and
    evaluations; returns (logs, evaluation seeds)."""
    seeds = []

    def fake_evaluate(env, agent, rng, num_episodes=32, **kw):
        seeds.append(rng)
        return {"eval/return_mean": 10.0 * len(seeds),
                "eval/success_rate": successes[len(seeds) - 1]}

    monkeypatch.setattr(runner_module, "evaluate", fake_evaluate)
    agent = types.SimpleNamespace(state=types.SimpleNamespace(params={"w": array(np.ones(3))}))
    chunks = [0]

    def init_fn(agent, rng, demo_state=None):
        return types.SimpleNamespace(agent=agent, env_steps=array(0))

    def run_chunk(carry, num_iters):
        chunks[0] += 1
        c = chunks[0]
        steps = np.arange(1, num_iters + 1, dtype=np.int32) * 8 + (c - 1) * num_iters * 8
        m = {"env_steps": steps, "ep_count": np.full(num_iters, c, np.int32),
             "ret_sum": np.full(num_iters, 3.0 * c, np.float32),
             "succ_sum": np.full(num_iters, 0.5 * c, np.float32),
             "buffer_size": steps,
             **{k: np.full(num_iters, v * c, np.float32) for k, v in
                (("critic_loss", 1.0), ("actor_loss", -2.0), ("temperature", 0.01),
                 ("entropy", 0.5))}}
        return types.SimpleNamespace(agent=carry.agent, env_steps=array(int(steps[-1]))), \
            {k: array(v) for k, v in m.items()}

    logger = _RecordingLogger()
    rb = types.SimpleNamespace(image_keys=())
    runner_module.run_fused(None, agent, rb, None, init_fn, run_chunk, logger=logger,
                            chunk_iters=2, **kwargs)
    return logger.logs, seeds


def _comparable(log):
    out = {k: v for k, v in log.items() if k not in ("env_steps_per_s", "timer")}
    return out, set(log["timer"])


@pytest.mark.parametrize("success_stop,successes,chunks", [
    (0.97, [0.5, 0.98, 0.2, 0.97, 0.99, 1.0], 5),  # two in a row at chunks 4 and 5
    (None, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6], 6),
])
def test_torch_run_fused_matches_jax(monkeypatch, success_stop, successes, chunks):
    kw = dict(total_env_steps=96, eval_period_chunks=1, success_stop=success_stop)
    jlogs, jseeds = _stub_run(jrunner, jnp.asarray, successes, monkeypatch, **kw)
    tlogs, tseeds = _stub_run(trunner, torch.as_tensor, successes, monkeypatch, **kw)
    assert len(tlogs) == len(jlogs) == chunks
    for (ts, tl), (js, jl) in zip(tlogs, jlogs):
        assert ts == js and set(tl) == set(jl)
        assert _comparable(tl) == _comparable(jl)
    assert {"eval/success_rate", "eval/return_mean", "train/episode_return", "train/entropy",
            "buffer_size"} <= set(tlogs[0][1])
    assert tseeds == [10_000 + c for c in range(1, chunks + 1)]
    assert [np.asarray(k).tolist() for k in jseeds] == [
        np.asarray(jax.random.PRNGKey(10_000 + c)).tolist() for c in range(1, chunks + 1)]


def test_torch_run_fused_keeps_the_best_params(monkeypatch):
    env, agent, rb, config, init_fn, run_chunk = _small_experiment(random_steps=0)
    opt = {"learning_rate": 1e-3}
    agent.init_train_state(opt, opt, opt)  # no lr warm-up: the params move from the first update
    successes = iter([0.9, 0.5, 0.1])
    monkeypatch.setattr(trunner, "evaluate",
                        lambda *a, **k: {"eval/return_mean": 1.0,
                                         "eval/success_rate": next(successes)})
    snapshots = []
    carry, best = trunner.run_fused(
        env, agent, rb, config, init_fn, run_chunk, total_env_steps=24, chunk_iters=2,
        eval_period_chunks=1, logger=_RecordingLogger(),
        log_fn=lambda log, carry: snapshots.append(
            {g: [p.detach().clone() for p in ps] for g, ps in carry.agent.state.params.items()}))
    assert len(snapshots) == 3 and (best["success"], best["steps"]) == (0.9, 8)
    for g, ps in snapshots[0].items():
        for p, q, live in zip(ps, best["params"][g], carry.agent.state.params[g]):
            assert torch.equal(p, q) and q is not live
    moved = [not torch.equal(p, q) for p, q in zip(snapshots[0]["actor"], agent.state.params["actor"])]
    assert any(moved)  # the live params trained on after the best evaluation


def test_torch_evaluate_uses_a_custom_obs_fn():
    class ShortEnv(PandaPickCubeEnv):
        time_limit_steps = 3

    env = ShortEnv(device="cpu")
    agent = make_state_sim_experiment(device="cpu", num_envs=2)[1]
    calls = []

    def obs_fn(o):
        calls.append(o)
        return flatten_obs(o)

    out = evaluate(env, agent, 0, num_episodes=2, obs_fn=obs_fn)
    assert len(calls) == 3 and set(out) == {"eval/return_mean", "eval/success_rate"}


# ---------------------------------------------------------------- config


def test_torch_workload_presets_equal_jax():
    assert [f.name for f in dataclasses.fields(tconfig.WorkloadConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.WorkloadConfig)]
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    for name, cfg in jconfig.PRESETS.items():
        assert dataclasses.asdict(tconfig.PRESETS[name]) == dataclasses.asdict(cfg), name
        port = tconfig.PRESETS[name]
        assert port.loop_overrides() == cfg.loop_overrides(), name
        assert port.runner_kwargs() == cfg.runner_kwargs(), name
        assert LoopConfig(**port.loop_overrides()).demo_fraction == cfg.demo_fraction
    params = set(inspect.signature(trunner.run_fused).parameters)
    assert set(tconfig.WorkloadConfig().runner_kwargs()) <= params
    tc = tconfig.WorkloadConfig.preset("state_sim", port=6100).trainer_config()
    assert isinstance(tc, TrainerConfig)
    assert (tc.port_number, tc.broadcast_port, tc.request_types) == (6100, 6101, ["send-stats"])
    jtc = jconfig.WorkloadConfig.preset("state_sim", port=6100).trainer_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jtc)
    p = argparse.ArgumentParser()
    tconfig.WorkloadConfig.add_args(p, preset="drq_sim")
    cfg = tconfig.WorkloadConfig.from_args(p.parse_args(["--utd_ratio", "2", "--num_envs", "4"]))
    assert (cfg.utd_ratio, cfg.num_envs, cfg.algo, cfg.discount) == (2, 4, "drq", 0.96)


@pytest.mark.parametrize("argv", [["--preset", "peg_insert"], ["--algo", "drq"],
                                  ["--image_obs", "true"], ["--discount", "0.96"],
                                  ["--critic_ensemble_size", "4"], ["--temperature_init", "0.1"],
                                  ["--port", "6000"], ["--steps_per_update", "10"]])
def test_torch_state_example_raises_on_a_setting_it_does_not_read(argv):
    with pytest.raises(ValueError, match="refused, not ignored"):
        fused_sac_state_sim.main(["--rlpd", "--device", "cpu"] + argv)


def test_torch_launcher_passes_the_rlpd_and_intervention_fields():
    fields = dict(demo_fraction=0.5, intervention_prob=0.3, intervention_mode="rescue",
                  intervention_decay_steps=100, intervention_min_prob=0.1)
    config = _small_experiment(**fields)[3]
    assert {k: getattr(config, k) for k in fields} == fields
    with pytest.raises(ValueError, match="intervention_mode"):
        _small_experiment(intervention_mode="sometimes")
