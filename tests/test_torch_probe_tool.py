"""The port's peg probe against the JAX package's `tools/probe_peg.py`, on
the CPU.

- `probe_batches` picks the rows the JAX tool picks (`jnp.where(rew > 0,
  size=...)`, every stream's first row);
- `probe_q` against JAX's `forward_critic(...).mean()` on a JAX agent's
  params grafted into the port's (Q_ATOL);
- `eval_pose_error` against the JAX tool's `eval_rollout` formula
  (`tools/probe_peg.py:132-151`) run by serl_tpu's agent and peg env from
  JAX's reset keys (a 3-step time limit, the target's roll at -pi where
  the tcp's sits near +pi): the success rate exactly, the per-dim pose
  error within POSE_ATOL, the roll's only small once wrapped to [0, pi];
- `main` end to end at a tiny size (a 3-step time limit, 2 envs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import tasks as jtasks
from serl_tpu.training.launcher import make_sac_agent as jax_sac_agent
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.tools import probe_peg
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils.jax_params import load_sac_params
from tests.torch_pose_jax import jax_reset_draws

Q_ATOL = 1e-5
POSE_ATOL = 1e-4
STEPS = 3  # the pose env's time limit in these tests


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_torch_probe_batches_pick_the_jax_tools_rows():
    streams, t = 3, 5
    rew = np.zeros(streams * t, np.float32)
    rew[[2, 4, 9, 13]] = 1.0
    rew[7] = -0.1  # the gripper penalty: not a positive row
    g = torch.Generator().manual_seed(0)
    trans = {"rewards": torch.from_numpy(rew),
             "observations": torch.randn((streams * t, 13), generator=g),
             "actions": torch.randn((streams * t, 7), generator=g)}
    pos, early = probe_peg.probe_batches(trans, t)
    jrew = jnp.asarray(rew)
    pos_idx = np.asarray(jnp.where(jrew > 0, size=min(256, int((jrew > 0).sum())))[0])
    early_idx = np.asarray(jnp.arange(0, jrew.shape[0], t))
    for got, idx in ((pos, pos_idx), (early, early_idx)):
        for k in ("observations", "actions"):
            torch.testing.assert_close(got[k], trans[k][torch.from_numpy(np.array(idx)).long()], atol=0,
                                       rtol=0)


def _jax_eval_rollout(jagent, jenv, cfg, keys):
    """The JAX tool's `eval_rollout` (tools/probe_peg.py:132-151)."""
    states, obs = jax.vmap(jenv.reset)(keys)

    def body(carry, _):
        states, obs, succ = carry
        actions = jagent.sample_actions(jpick.flatten_obs(obs), argmax=True)
        states, obs, r, d, info = jax.vmap(jenv.step)(states, actions)
        return (states, obs, jnp.maximum(succ, info["success"])), None

    n = keys.shape[0]
    (states, obs, succ), _ = jax.lax.scan(body, (states, obs, jnp.zeros(n)), None,
                                          length=cfg.time_limit_steps)
    pose = jax.vmap(jenv._pose)(states)
    err = jnp.abs(pose - jnp.asarray(cfg.target_pose))
    err = err.at[:, 3:].set(jnp.minimum(err[:, 3:], 2 * jnp.pi - err[:, 3:]))
    return succ.mean(), err.mean(axis=0)


def test_torch_probe_readings_match_the_jax_tools_formulas():
    jagent = jax_sac_agent(0, obs_dim=probe_peg.OBS_DIM, action_dim=probe_peg.ACT_DIM,
                           discount=0.97)
    agent = make_sac_agent(1, obs_dim=probe_peg.OBS_DIM, action_dim=probe_peg.ACT_DIM,
                           discount=0.97, device="cpu")
    load_sac_params(agent, jax.tree.map(np.asarray, jagent.state.params))
    g = np.random.default_rng(0)
    batch = lambda n: {"observations": g.normal(size=(n, 13)).astype(np.float32),
                       "actions": g.uniform(-1, 1, size=(n, 7)).astype(np.float32)}
    pos, early = batch(6), batch(3)
    as_torch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    got = probe_peg.probe_q(agent, as_torch(pos), as_torch(early))
    for q, b in zip(got, (pos, early)):
        want = jagent.forward_critic(b["observations"], b["actions"], rng=None).mean()
        assert q.shape == () and abs(float(q) - float(want)) <= Q_ATOL, (float(q), float(want))

    # the target's roll at -pi: the tcp's roll sits near +pi, so its error
    # is only small once wrapped
    target = (0.40, 0.10, 0.045, -math.pi, 0.0, 0.0)
    jcfg = jtasks.PEG_INSERT_CONFIG._replace(time_limit_steps=STEPS, target_pose=target)
    cfg = tasks.PEG_INSERT_CONFIG._replace(time_limit_steps=STEPS, target_pose=target)
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    want_succ, want_err = _jax_eval_rollout(jagent, jtasks.PandaPoseTaskEnv(jcfg), jcfg, keys)
    env = tasks.PandaPoseTaskEnv(cfg, device="cpu")
    succ, err = probe_peg.eval_pose_error(agent, env, jax_reset_draws(keys, cfg))
    assert float(succ) == float(want_succ)
    assert err.shape == (6,) and float(err[3]) < 0.1
    np.testing.assert_allclose(err.numpy(), np.asarray(want_err), atol=POSE_ATOL, rtol=0)


def test_torch_probe_main_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(probe_peg, "PEG_INSERT_CONFIG",
                        tasks.PEG_INSERT_CONFIG._replace(time_limit_steps=STEPS))
    monkeypatch.setattr(probe_peg, "EVAL_EPISODES", 2)
    records = probe_peg.main(["--device", "cpu", "--num_envs", "2", "--num_demos", "2",
                              "--batch_size", "8", "--utd_ratio", "2", "--total_steps", "4",
                              "--eval_period", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("demo mean per-step success")
    assert lines[1].startswith(f"demo transitions: {2 * STEPS}, episodes")
    assert [r["steps"] for r in records] == [2, 4]
    assert all(line.startswith("steps ") and "err xyz" in line for line in lines[2:])
    # 3-step demos never succeed: no reward > 0 row, and Q_pos is the mean of
    # an empty batch, NaN, as in the JAX tool
    assert "reward>0 frac 0.000" in lines[1]
    for r in records:
        assert math.isnan(r["Q_pos"])
        assert all(math.isfinite(v) for v in [r[k] for k in ("Q_early", "alpha", "H",
                                                             "eval_succ")] + r["err"])
