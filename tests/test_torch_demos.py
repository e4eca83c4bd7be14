"""The port's demo path against serl_tpu's, on the CPU.

- `expert_action` on the states of a port rollout of the expert (every
  phase: above the block, descending, closing, lifting) against JAX's
  vmapped expert on the same states: actions to 1e-5 in every env whose
  phase quantities (xy error, gripper angle, block height, tcp height over
  the block) lie more than 1e-4 from their thresholds, at least 90% of the
  states compared; and with one (4,) noise vector for every env, JAX's own
  draw.
- `collect_episodes`, with and without auto-reset, replayed step by step
  through JAX's `step` / `step_auto_reset` from the port's own state before
  each step (re-synced each step), with the actions the port stored:
  observations and rewards to 1e-3 (tests/test_torch_env.py), flags and
  ep_ids exactly.
- `filter_successful`, `take_transitions`, `select_demo_episodes`, the demo
  pickle both ways and `demos_to_buffer` against JAX's on the same numpy
  transitions: exactly; the example's `scripted_demos` keeps what JAX's
  example keeps and counts the successful episodes.
"""

import types


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data import demos as jdemos
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import scripted_expert as jexpert
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.training.launcher import make_state_replay_buffer as jax_buffer
from serl_tpu_torch.data import demos
from serl_tpu_torch.envs import panda_pick
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.examples import fused_sac_state_sim
from serl_tpu_torch.examples.fused_sac_state_sim import expert_demo_policy
from serl_tpu_torch.training.launcher import make_state_replay_buffer

N, ATOL, MARGIN = 4, 1e-3, 1e-4
ROLLOUT = 102  # past the 100-step time limit: every env auto-resets once


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to_jax(state):
    n = state.t.shape[0]
    return jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in state.physics)),
        t=jnp.asarray(state.t.numpy()),
        z_init=jnp.asarray(state.z_init.numpy()),
        rng=jax.random.split(jax.random.PRNGKey(0), n),
        ep_id=jnp.asarray(state.ep_id.numpy()),
    )


def _recording(policy):
    """`policy` that also records the states it acts on (the pre-step states)."""
    seen = []

    def fn(states, generator):
        seen.append(states)
        return policy(states, generator)

    return fn, seen


@pytest.fixture(scope="module")
def expert_rollout():
    torch.set_num_threads(1)
    env = panda_pick.PandaPickCubeEnv(device="cpu")
    policy, seen = _recording(expert_demo_policy)
    trs = demos.collect_episodes(env, policy, torch.Generator().manual_seed(3), N,
                                 episode_len=ROLLOUT, auto_reset=True)
    return trs, seen


def _cat_states(states):
    return panda_pick.EnvState(*(
        engine.PhysicsState(*(torch.cat(f) for f in zip(*(s.physics for s in states))))
        if i == 0 else torch.cat([s[i] for s in states]) for i in range(4)))


def test_torch_expert_action_matches_jax(expert_rollout):
    _, seen = expert_rollout
    states = _cat_states(seen)
    tcp, _, block = (x.numpy() for x in engine.observe(states.physics))
    theta = states.physics.theta.numpy()
    xy_err = np.sqrt(((tcp[:, :2] - block[:, :2]) ** 2).sum(-1))
    quantities = ((xy_err, 0.010), (theta, 0.25), (block[:, 2], 0.06),
                  (tcp[:, 2] - block[:, 2], 0.012))
    far = np.all([np.abs(q - t) > MARGIN for q, t in quantities], axis=0)
    assert far.mean() >= 0.9, far.mean()
    # the compared states hold every phase of the expert
    compared = {"above": xy_err >= 0.010, "aligned": xy_err < 0.010, "closing": theta > 0.25,
                "lifted": block[:, 2] > 0.06}
    assert all((mask & far).any() for mask in compared.values()), compared

    js = _to_jax(states)
    want = np.asarray(jax.vmap(lambda s: jexpert.expert_action(s, None, 0.0))(js))
    got = expert_action(states).numpy()
    np.testing.assert_allclose(got[far], want[far], atol=1e-5, rtol=0)
    assert np.abs(got).max() <= 1.0

    # one noise vector for every env: the JAX example's vmap with in_axes=(0, None)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.vmap(lambda s, k: jexpert.expert_action(s, k, noise_scale=0.02),
                               in_axes=(0, None))(js, key))
    noise = torch.tensor(np.asarray(0.02 * jax.random.normal(key, (4,))))
    np.testing.assert_allclose(expert_action(states, noise).numpy()[far], want[far], atol=1e-5,
                               rtol=0)


def _replay(trs, seen, steps, auto_reset):
    """Replay every stored step through JAX from the port's own pre-step state."""
    jenv = jpick.PandaPickCubeEnv()
    jstep = jax.jit(jax.vmap(jenv.step_auto_reset if auto_reset else jenv.step))
    jobs = jax.jit(jax.vmap(lambda s: jpick.flatten_obs(jenv._obs(s))))
    d = {k: v.numpy().reshape((N, steps) + tuple(v.shape[1:])) for k, v in trs.items()}
    resets = 0
    for t in range(steps):
        before = seen[t]
        js = _to_jax(before)
        np.testing.assert_allclose(d["observations"][:, t], np.asarray(jobs(js)), atol=ATOL, rtol=0)
        _, jo, jr, jd, ji = jstep(js, jnp.asarray(d["actions"][:, t]))
        np.testing.assert_allclose(d["rewards"][:, t], np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d["dones"][:, t], np.asarray(jd))
        np.testing.assert_array_equal(d["masks"][:, t], 1.0 - np.asarray(jd))
        np.testing.assert_array_equal(d["success"][:, t], np.asarray(ji["success"]))
        stored_next = ji["final_obs"] if auto_reset else jo
        np.testing.assert_allclose(d["next_observations"][:, t],
                                   np.asarray(jpick.flatten_obs(stored_next)), atol=ATOL, rtol=0)
        want_ep = before.ep_id.numpy() * N + np.arange(N) if auto_reset else np.arange(N)
        np.testing.assert_array_equal(d["ep_ids"][:, t], want_ep)
        done = np.asarray(jd) > 0.5
        if done.any() and t + 1 < steps:
            resets += 1
            after = seen[t + 1]
            # the port reset these envs at its own xy: JAX's reset state there
            fresh = jax.vmap(jengine.init_state)(jnp.asarray(after.physics.cube_pos[:, :2].numpy()))
            np.testing.assert_allclose(
                d["observations"][done, t + 1],
                np.asarray(jobs(_to_jax(after)._replace(physics=fresh)))[done], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(after.ep_id.numpy()[done], before.ep_id.numpy()[done] + 1)
    return resets


def test_torch_collect_episodes_auto_reset_replays_through_jax(expert_rollout):
    trs, seen = expert_rollout
    assert trs["observations"].shape == (N * ROLLOUT, panda_pick.STATE_OBS_DIM)
    assert trs["ep_ids"].dtype == torch.int32
    assert _replay(trs, seen, ROLLOUT, auto_reset=True) == 1  # step 100 resets every env
    succ = trs["success"].reshape(N, ROLLOUT)[:, :100].amax(1)
    assert succ.sum() >= 2, succ  # the expert lifts the cube in most episodes


def test_torch_collect_episodes_fixed_length_replays_through_jax():
    env = panda_pick.PandaPickCubeEnv(device="cpu")
    policy, seen = _recording(expert_demo_policy)
    steps = 10
    trs = demos.collect_episodes(env, policy, torch.Generator().manual_seed(4), N,
                                 episode_len=steps)
    assert _replay(trs, seen, steps, auto_reset=False) == 0
    np.testing.assert_array_equal(trs["ep_ids"].numpy(), np.repeat(np.arange(N), steps))


EPISODES, LEN = 5, 4


def _transitions(seed=0):
    rng = np.random.default_rng(seed)
    n = EPISODES * LEN
    f = lambda *shape: rng.normal(size=(n,) + shape).astype(np.float32)
    success = np.zeros((EPISODES, LEN), np.float32)
    success[[1, 3, 4], 2:] = 1.0  # episodes 1, 3 and 4 succeed
    return {"observations": f(10), "actions": f(4), "next_observations": f(10), "rewards": f(),
            "masks": np.ones(n, np.float32), "dones": np.zeros(n, np.float32),
            "success": success.reshape(-1),
            "ep_ids": np.repeat(np.arange(EPISODES, dtype=np.int32), LEN)}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
        assert g.dtype == np.asarray(want[k]).dtype, k


def test_torch_demo_selection_matches_jax():
    tr = _transitions()
    jt = {k: jnp.asarray(v) for k, v in tr.items()}
    _equal(demos.filter_successful(tr, LEN), jdemos.filter_successful(jt, LEN))
    _equal(demos.filter_successful({k: torch.from_numpy(v) for k, v in tr.items()}, LEN),
           jdemos.filter_successful(jt, LEN))
    _equal(demos.take_transitions({k: torch.from_numpy(v) for k, v in tr.items()}, 6),
           jdemos.take_transitions(jt, 6))
    for k in (2, 4):  # enough successful episodes, and a fall back to an unsuccessful one
        _equal(demos.select_demo_episodes(tr, k, LEN), jdemos.select_demo_episodes(jt, k, LEN))


def test_torch_demo_pickle_and_buffer_match_jax(tmp_path):
    tr = _transitions(1)
    jax_file, port_file = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jdemos.save_demos({k: jnp.asarray(v) for k, v in tr.items()}, jax_file)
    loaded = demos.load_demos(jax_file)
    _equal(loaded, tr)
    demos.save_demos({k: torch.from_numpy(v) for k, v in tr.items()}, port_file)
    _equal(jdemos.load_demos(port_file), tr)

    want = jdemos.demos_to_buffer(jax_buffer(100), jdemos.load_demos(jax_file), LEN)
    got = demos.demos_to_buffer(make_state_replay_buffer(100, device="cpu"), loaded, LEN)
    assert (got.insert_slot, got.size) == (int(want.insert_slot), int(want.size)) == (0, LEN)
    np.testing.assert_array_equal(got.ep_id.numpy(), np.asarray(want.ep_id))
    assert got.ep_id.dtype == torch.int32 and got.ep_id.shape == (LEN, EPISODES)
    _equal(got.data, want.data)
    assert all(v.is_contiguous() for v in got.data.values())


def test_torch_scripted_demos_keeps_the_successful_episodes(monkeypatch):
    """The example's demo collection: num_demos + 10 expert episodes from a
    generator seeded with seed + 7, the first num_demos episodes' worth of
    the successful ones (JAX's example: filter_successful, then
    take_transitions), and the number of successful episodes."""
    tr = _transitions()
    calls = []

    def collect(env, policy, generator, num_episodes, episode_len):
        calls.append((policy, generator.initial_seed(), num_episodes, episode_len))
        return {k: torch.from_numpy(v) for k, v in tr.items()}

    monkeypatch.setattr(fused_sac_state_sim, "collect_episodes", collect)
    kept, succeeded = fused_sac_state_sim.scripted_demos(types.SimpleNamespace(device="cpu"),
                                                         seed=3, num_demos=2, episode_len=LEN)
    assert calls == [(expert_demo_policy, 10, 12, LEN)]
    assert succeeded == 3
    jt = {k: jnp.asarray(v) for k, v in tr.items()}
    _equal(kept, jdemos.take_transitions(jdemos.filter_successful(jt, LEN), 2 * LEN))
