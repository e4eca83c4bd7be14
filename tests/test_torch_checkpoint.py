"""Checkpoints, pause and resume, and checkpoint evaluation, on the CPU.

- `CheckpointManager`: a round trip of a tree with every kind of leaf
  (tensors, an `nn.Parameter` restored in place, ints, floats, a
  generator's state, NamedTuples, dataclasses, "/" in dict keys escaped as
  JAX's `_key` escapes them), `keep`, `latest_step`, orbax's rule that a
  step at or below the latest is not saved, a missing step or an empty
  directory -> FileNotFoundError, a leaf the checkpoint lacks left as the
  target's, a target of another dtype.
- `run_fused` paused by the pause file and resumed equals an uninterrupted
  run bit for bit, every leaf of the loop carry (state RLPD with episode
  interventions, and pixels).
- `eval_from_checkpoint` restores the best evaluation's params bit for bit
  (JAX's run_fused checkpoints them at each new best) and evaluates
  `num_rounds` rounds seeded seed + r.
- The examples' `--eval_checkpoint_step` and the checkpoint fields they now read.
"""

import dataclasses
import os
import types
from typing import NamedTuple

import pytest
import torch

from serl_tpu_torch.examples import fused_drq_sim, fused_sac_state_sim
from serl_tpu_torch.training import runner
from serl_tpu_torch.training.checkpointing import (
    CheckpointManager,
    flatten,
    restore_agent_params,
    save_agent_checkpoint,
)
from serl_tpu_torch.training.launcher import make_drq_sim_experiment, make_state_sim_experiment


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: int


@dataclasses.dataclass
class _Box:
    data: dict
    cursor: int


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    torch.rand(3, generator=g)  # a generator part-way through its stream
    return {"params": [torch.nn.Parameter(torch.randn(2, 3, generator=g))],
            "obs": {"panda/tcp_pos": torch.randn(4, 3, generator=g)},
            "pair": _Pair(torch.arange(3, dtype=torch.int32) + seed, seed),
            "box": _Box({"x": torch.randn(5, generator=g).double()}, seed + 1),
            "rate": 0.5 * seed, "rng": g, "skipped": None}


def test_torch_checkpoint_manager_round_trip(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    assert mngr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mngr.restore()
    for step in (10, 20, 30, 40, 50):
        assert mngr.save(step, _tree(step))
    assert mngr.steps() == [30, 40, 50] and mngr.latest_step() == 50  # keep=3
    assert not mngr.save(45, _tree(1)) and not mngr.save(50, _tree(1))  # orbax's rule
    assert mngr.steps() == [30, 40, 50]
    assert sorted(os.listdir(mngr.directory)) == ["30", "40", "50"]  # no temporary left
    with pytest.raises(FileNotFoundError):
        mngr.restore(20)
    flat = mngr.restore()  # the latest, as a flat dict
    assert "['obs']['panda|tcp_pos']" in flat and ".a" not in flat
    assert "['pair'].a" in flat and "['box'].cursor" in flat and flat["['rate']"] == 25.0

    target = _tree(0)
    param = target["params"][0]
    target["box"] = _Box({"x": torch.zeros(5, dtype=torch.float32)}, 0)  # another dtype
    del target["obs"]
    target["extra"] = torch.ones(2)  # absent from the checkpoint: kept
    got = mngr.restore(40, target=target)
    want = _tree(40)
    assert got["params"][0] is param and torch.equal(param, want["params"][0])
    assert isinstance(got["params"][0], torch.nn.Parameter)
    assert torch.equal(got["pair"].a, want["pair"].a) and got["pair"].b == 40
    assert got["box"].cursor == 41 and got["box"].data["x"].dtype == torch.float32
    assert torch.equal(got["box"].data["x"], want["box"].data["x"].float())
    assert got["rate"] == 20.0 and torch.equal(got["extra"], torch.ones(2))
    assert got["rng"] is target["rng"]
    assert torch.equal(torch.rand(4, generator=got["rng"]), torch.rand(4, generator=want["rng"]))
    mngr.close()


def test_torch_checkpoint_leaf_shape_mismatch_raises(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mngr.restore(target={"w": torch.zeros(4)})


def test_torch_save_agent_checkpoint_round_trip(tmp_path):
    agent = make_state_sim_experiment(device="cpu", num_envs=2)[1]
    saved = flatten({"p": agent.state.params, "t": agent.state.target_params})
    save_agent_checkpoint(str(tmp_path), agent, step=3)
    with torch.no_grad():
        for p in agent.parameters():
            p.add_(1.0)
        agent.state.target_params = {g: [t + 1.0 for t in ts]
                                     for g, ts in agent.state.target_params.items()}
    params = list(agent.parameters())
    restore_agent_params(str(tmp_path), agent)
    got = flatten({"p": agent.state.params, "t": agent.state.target_params})
    assert got.keys() == saved.keys() and all(torch.equal(got[k], saved[k]) for k in saved)
    assert all(p is q for p, q in zip(agent.parameters(), params))  # restored in place


# ---------------------------------------------------------------- run_fused


class _Logger:
    def log(self, data, step=None):
        pass

    def close(self):
        pass


def _experiment(pixels):
    if pixels:
        return make_drq_sim_experiment(device="cpu", num_envs=2, image_size=32, batch_size=4,
                                       utd_ratio=2, training_starts=0, random_steps=4,
                                       buffer_capacity=64)
    return make_state_sim_experiment(device="cpu", num_envs=4, training_starts=8, batch_size=4,
                                     utd_ratio=2, buffer_capacity=64, random_steps=8,
                                     demo_fraction=0.5, intervention_prob=0.5,
                                     intervention_mode="episode")


def _demo_ring(rb, pixels):
    if pixels:
        return None
    n, g = 3 * 5, torch.Generator().manual_seed(1)
    tr = {"observations": torch.randn(n, 10, generator=g),
          "actions": torch.rand(n, 4, generator=g) * 2 - 1,
          "next_observations": torch.randn(n, 10, generator=g), "rewards": -torch.ones(n),
          "masks": torch.ones(n), "dones": torch.zeros(n)}
    return rb.init_from_episodes(tr, torch.arange(3).repeat_interleave(5), 5)


def _run(pixels, checkpoint_dir=None, pause_at=None, resume=False, total=None):
    env, agent, rb, config, init_fn, run_chunk = _experiment(pixels)
    opt = {"learning_rate": 1e-3}
    agent.init_train_state(opt, opt, opt)  # no warm-up: the params move at once

    def log_fn(log, carry):
        if pause_at is not None and log["env_steps"] == pause_at:
            open(os.path.join(checkpoint_dir, "PAUSE"), "w").close()

    return runner.run_fused(
        env, agent, rb, config, init_fn, run_chunk, total_env_steps=total, chunk_iters=2,
        eval_period_chunks=1, seed=3, demo_state=_demo_ring(rb, pixels), logger=_Logger(),
        checkpoint_dir=checkpoint_dir, checkpoint_period_chunks=2, resume=resume, log_fn=log_fn)


@pytest.mark.parametrize("pixels", [False, True])
def test_torch_run_fused_resume_is_bit_identical(tmp_path, monkeypatch, pixels):
    monkeypatch.setattr(runner, "evaluate",
                        lambda *a, **k: {"eval/return_mean": 1.0, "eval/success_rate": 0.5})
    per_chunk = 2 * (2 if pixels else 4)
    total, pause_at = 5 * per_chunk, 2 * per_chunk
    full, _ = _run(pixels, total=total)
    ck = str(tmp_path)
    paused, _ = _run(pixels, ck, pause_at=pause_at, total=total)
    assert paused.env_steps == pause_at and not os.path.exists(os.path.join(ck, "PAUSE"))
    assert CheckpointManager(os.path.join(ck, "pause")).steps() == [pause_at]
    resumed, _ = _run(pixels, ck, resume=True, total=total)
    want, got = flatten(full), flatten(resumed)
    assert got.keys() == want.keys()
    assert any("rng" in k for k in got) and any("opt_states" in k for k in got)
    unequal = [k for k in want if not (torch.equal(got[k], want[k])
                                       if isinstance(want[k], torch.Tensor) else got[k] == want[k])]
    assert not unequal, unequal[:10]
    assert resumed.env_steps == total and resumed.rb_state.size == full.rb_state.size
    fresh = _experiment(pixels)[1]
    assert not torch.equal(full.agent.state.params["critic"][0], fresh.state.params["critic"][0])
    # the periodic and final agent checkpoints
    assert CheckpointManager(ck).latest_step() == total
    with pytest.raises(FileNotFoundError):
        _run(pixels, str(tmp_path / "empty"), resume=True, total=total)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(pixels, resume=True, total=total)


def test_torch_eval_from_checkpoint_restores_the_best_params(tmp_path, monkeypatch):
    successes = iter([0.2, 0.9, 0.5])
    monkeypatch.setattr(runner, "evaluate",
                        lambda *a, **k: {"eval/return_mean": 1.0,
                                         "eval/success_rate": next(successes)})
    carry, best = _run(False, str(tmp_path), total=24)
    assert (best["success"], best["steps"]) == (0.9, 16)
    mngr = CheckpointManager(str(tmp_path))
    assert 16 in mngr.steps() and mngr.latest_step() == 24  # best, then the final save
    env, agent, rb, *_ = _experiment(False)
    seen = []

    def fake_evaluate(env, agent, rng, num_episodes=32, **kw):
        seen.append((rng, num_episodes, {g: [p.clone() for p in ps]
                                         for g, ps in agent.state.params.items()}))
        return {"eval/return_mean": 2.0, "eval/success_rate": 0.25 * len(seen)}

    monkeypatch.setattr(runner, "evaluate", fake_evaluate)
    params = list(agent.parameters())
    got_agent, mean = runner.eval_from_checkpoint(env, agent, rb, str(tmp_path), step=16,
                                                  num_episodes=5, num_rounds=2, seed=7)
    assert got_agent is agent and all(p is q for p, q in zip(agent.parameters(), params))
    assert [s[:2] for s in seen] == [(7, 5), (8, 5)] and mean == pytest.approx(0.375)
    for g, ps in best["params"].items():
        for p, q in zip(ps, seen[0][2][g]):
            assert torch.equal(p, q), g
    # the latest step by default: the final params
    runner.eval_from_checkpoint(env, agent, rb, str(tmp_path))
    for g, ps in carry.agent.state.params.items():
        assert all(torch.equal(p, q) for p, q in zip(ps, agent.state.params[g])), g
    with pytest.raises(FileNotFoundError):
        runner.eval_from_checkpoint(env, agent, rb, str(tmp_path / "none"))


# ---------------------------------------------------------------- examples

EXAMPLES = {"state": (fused_sac_state_sim, make_state_sim_experiment, ["--num_envs", "2"]),
            "pixels": (fused_drq_sim, make_drq_sim_experiment,
                       ["--num_envs", "2", "--image_size", "32", "--buffer_capacity", "64"])}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_torch_example_eval_checkpoint_step(tmp_path, monkeypatch, name):
    module, make, argv = EXAMPLES[name]
    kw = {"image_size": 32, "buffer_capacity": 64} if name == "pixels" else {}
    trained = make(device="cpu", num_envs=2, **kw)[1]
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(0.5)
    CheckpointManager(str(tmp_path)).save(12, {"agent_params": trained.state.params})
    seen = []
    monkeypatch.setattr(runner, "evaluate", lambda env, agent, rng, num_episodes=32, **k:
                        seen.append((rng, num_episodes)) or {"eval/return_mean": 0.0,
                                                             "eval/success_rate": 1.0})
    agent, mean = module.main(["--device", "cpu", "--checkpoint_dir", str(tmp_path),
                               "--eval_checkpoint_step", "-1", "--eval_n_trajs", "3",
                               "--seed", "4"] + argv)
    assert mean == 1.0 and seen == [(4, 3)]
    for p, q in zip(agent.parameters(), trained.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        module.main(["--device", "cpu", "--eval_checkpoint_step", "12"] + argv)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_torch_example_passes_the_checkpoint_fields(tmp_path, monkeypatch, name):
    module, _, argv = EXAMPLES[name]
    calls = []
    monkeypatch.setattr(module, "run_fused", lambda *a, **kw: calls.append(kw))
    module.main(["--device", "cpu", "--checkpoint_dir", str(tmp_path),
                 "--checkpoint_period_chunks", "5", "--pause_file", str(tmp_path / "P"),
                 "--resume", "true"] + argv)
    (kw,) = calls
    assert (kw["checkpoint_dir"], kw["checkpoint_period_chunks"], kw["pause_file"],
            kw["resume"]) == (str(tmp_path), 5, str(tmp_path / "P"), True)


def test_torch_checkpoint_carry_keys_escape_slashes():
    carry = types.SimpleNamespace()  # not a structure the checkpoint walks: left out
    flat = flatten({"obs": {"panda/tcp_pos": torch.zeros(1)}, "other": carry})
    assert list(flat) == ["['obs']['panda|tcp_pos']"]
