"""The port's goal-conditioned env layer against serl_tpu's, on the CPU; the
trajectory loader and the dm_env adapter against JAX's.

The JAX layer is single-env and vmapped, each env drawing its reset position
and its goal from keys in its state; the port's wraps the batched pick env
and takes those draws as explicit tensors. The test replays JAX's key
splits (goal_conditioned.py:59-65 and :98-104, panda_pick.py's reset) to
feed the port JAX's own reset positions and goal draws, and hands the
port's physics to JAX before every step, so that float32 drift cannot hide
a fault. Envs run 2 steps of random actions, then half of them are put on
their episode's last step (t = 99), as tests/test_goal_conditioned.py does,
and step once more, so that goals are redrawn where `done`.

Held: goals exactly equal (a bank entry, or the sampler's block position
plus JAX's offset: copies and one float add); done exactly; rewards
exactly, except where the block's distance to the goal lies within 1e-3 of
the 0.05 threshold (ROADMAP's rule for thresholds: the two physics agree to
the env tests' 1e-3, tests/test_torch_env.py); observations to that 1e-3.
Two cases are fixed by the draws and checked to occur: a done env whose
terminal reward against its old goal is 1 while against its new goal it is
0, and a done env whose new goal differs from its old one. The planted
faults this file catches: the terminal reward taken against the new goal,
and no goal redraw on done.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import goal_conditioned as jgc
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import goal_conditioned as tgc
from serl_tpu_torch.envs import panda_pick

OBS_ATOL = 1e-3
THRESHOLD = 0.05
MARGIN = 1e-3
OFFSET = 0.05  # the sampler's goal: the block's position plus U(-OFFSET, OFFSET) per axis


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bank(n=8, seed=0):
    lo, hi = jpick.SAMPLING_BOUNDS
    xy = np.random.default_rng(seed).uniform(lo, hi, (n, 2))
    return {"block_pos": np.concatenate([xy, np.full((n, 1), float(jengine.CUBE_HALF[2]))], -1)
            .astype(np.float32)}


def _jax_sampler(rng, obs):
    off = jax.random.uniform(rng, (3,), minval=-OFFSET, maxval=OFFSET)
    return {"block_pos": obs["state"]["block_pos"] + off}


def _port_sampler(draws, obs):
    return {"block_pos": obs["state"]["block_pos"] + draws}


# ---------------------------------------------------------------- JAX's draws


def _reset_draws(key, sampler, n_bank):
    """The reset position and goal draw JAX's GC reset takes from `key`."""
    rng, goal_rng, _ = jax.random.split(key, 3)
    _, k_block, _ = jax.random.split(rng, 3)
    xy = jax.random.uniform(k_block, (2,), minval=jpick.SAMPLING_BOUNDS[0],
                            maxval=jpick.SAMPLING_BOUNDS[1])
    return xy, _goal_draw(goal_rng, sampler, n_bank)


def _goal_draw(rng, sampler, n_bank):
    if sampler == "bank":
        return jax.random.randint(rng, (), 0, n_bank)
    return jax.random.uniform(rng, (3,), minval=-OFFSET, maxval=OFFSET)


def _step_draws(state, sampler, n_bank):
    """The auto-reset position and goal draw of JAX's step_auto_reset."""
    _, k_block, _ = jax.random.split(state.inner.rng, 3)
    xy = jax.random.uniform(k_block, (2,), minval=jpick.SAMPLING_BOUNDS[0],
                            maxval=jpick.SAMPLING_BOUNDS[1])
    _, sample_rng = jax.random.split(state.goal_rng)
    return xy, _goal_draw(sample_rng, sampler, n_bank)


def _t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def _with_port_physics(jstate, port_inner):
    """JAX's GC state with the port's physics, step count and episode ids
    (its keys and goals kept)."""
    inner = jstate.inner._replace(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in port_inner.physics)),
        t=jnp.asarray(port_inner.t.numpy()), z_init=jnp.asarray(port_inner.z_init.numpy()),
        ep_id=jnp.asarray(port_inner.ep_id.numpy()))
    return jstate._replace(inner=inner)


def _assert_obs(got, want):
    for k in want["state"]:
        np.testing.assert_allclose(got["state"][k].numpy(), np.asarray(want["state"][k]),
                                   atol=OBS_ATOL, rtol=0, err_msg=k)


def _assert_rewards(got, want, obs, goal):
    """Exactly equal where the distance is clear of the threshold."""
    d = np.linalg.norm(np.asarray(obs["state"]["block_pos"]) - np.asarray(goal["block_pos"]),
                       axis=-1)
    clear = np.abs(d - THRESHOLD) > MARGIN
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])
    return clear


@pytest.mark.parametrize("n,sampler", [(3, "bank"), (16, "bank"), (16, "sampler")])
def test_torch_gc_env_matches_jax(n, sampler):
    bank = _bank()
    reward = ("state/block_pos", THRESHOLD)
    jenv = jgc.make_gc_env(jpick.PandaPickCubeEnv(),
                           jax.tree.map(jnp.asarray, bank) if sampler == "bank" else _jax_sampler,
                           jgc.goal_distance_reward(*reward))
    env = tgc.make_gc_env(panda_pick.PandaPickCubeEnv(device="cpu"),
                          bank if sampler == "bank" else _port_sampler,
                          tgc.goal_distance_reward(*reward))
    n_bank = bank["block_pos"].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(n), n)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    xy, draws = jax.vmap(lambda k: _reset_draws(k, sampler, n_bank))(keys)
    state, obs = env.reset(n, reset_xy=_t(xy), goal_draws=_t(draws))
    np.testing.assert_array_equal(obs["goal"]["block_pos"].numpy(), np.asarray(jobs["goal"]["block_pos"]))
    _assert_obs(obs["observation"], jobs["observation"])
    if sampler == "bank":
        np.testing.assert_array_equal(state.goal["block_pos"].numpy(),
                                      bank["block_pos"][np.asarray(draws)])

    jstep = jax.jit(jax.vmap(jenv.step_auto_reset))
    rng = np.random.default_rng(n + 1)
    last = (n + 1) // 2  # envs [0, last) are put on their episode's last step before step 3
    seen = {"terminal_old_goal_only": False, "new_goal": False}
    for i in range(3):
        if i == 2:
            t = state.inner.t.clone()
            t[:last] = panda_pick.TIME_LIMIT_STEPS - 1
            state = state._replace(inner=state.inner._replace(t=t))
        jstate = _with_port_physics(jstate, state.inner)
        xy, draws = jax.vmap(lambda s: _step_draws(s, sampler, n_bank))(jstate)
        a = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
        jnew, jo, jr, jd, ji = jstep(jstate, jnp.asarray(a))
        old_goal = state.goal
        state, o, r, d, info = env.step_auto_reset(state, torch.from_numpy(a), reset_xy=_t(xy),
                                                   goal_draws=_t(draws))
        done = np.asarray(jd) > 0.5
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert done.sum() == (last if i == 2 else 0)
        # goals: kept where running, JAX's new draw where done; final_obs keeps the old goal
        np.testing.assert_array_equal(o["goal"]["block_pos"].numpy(), np.asarray(jo["goal"]["block_pos"]))
        np.testing.assert_array_equal(state.goal["block_pos"].numpy(),
                                      np.asarray(jnew.goal["block_pos"]))
        np.testing.assert_array_equal(state.goal["block_pos"].numpy()[~done],
                                      old_goal["block_pos"].numpy()[~done])
        np.testing.assert_array_equal(info["final_obs"]["goal"]["block_pos"].numpy(),
                                      old_goal["block_pos"].numpy())
        _assert_obs(o["observation"], jo["observation"])
        _assert_obs(info["final_obs"]["observation"], ji["final_obs"]["observation"])
        # rewards: ended envs against the old goal from their terminal observation
        final = ji["final_obs"]["observation"]
        ref_obs = {"state": {"block_pos": np.where(done[:, None], final["state"]["block_pos"],
                                                   jo["observation"]["state"]["block_pos"])}}
        _assert_rewards(r, jr, ref_obs, {"block_pos": np.asarray(jstate.goal["block_pos"])})
        if done.any():
            term_old = tgc.goal_distance_reward(*reward)(info["final_obs"]["observation"],
                                                         old_goal)
            term_new = tgc.goal_distance_reward(*reward)(info["final_obs"]["observation"],
                                                         state.goal)
            seen["terminal_old_goal_only"] = bool(((term_old == 1) & (term_new == 0))[done].any())
            seen["new_goal"] = bool((state.goal["block_pos"] != old_goal["block_pos"])
                                    .any(-1)[done].any())
    assert seen["new_goal"]
    if sampler == "sampler":  # the goals follow the blocks: the terminal reward depends on which goal
        assert seen["terminal_old_goal_only"]


def test_torch_gc_env_draws_its_own_goals_and_steps_without_reset():
    """Without explicit draws the goals come from the generator (bank indices
    in range); `step` recomputes the reward and keeps the goal."""
    bank = _bank(4)
    env = tgc.make_gc_env(panda_pick.PandaPickCubeEnv(device="cpu"), bank,
                          tgc.goal_distance_reward("state/block_pos", THRESHOLD, sparse=False))
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(5, g)
    assert any(torch.equal(state.goal["block_pos"][i], torch.from_numpy(b))
               for i in range(5) for b in bank["block_pos"])
    assert env.time_limit_steps == panda_pick.TIME_LIMIT_STEPS
    new, o, r, d, _ = env.step(state, torch.zeros(5, 4))
    assert torch.equal(new.goal["block_pos"], state.goal["block_pos"])
    dist = (o["observation"]["state"]["block_pos"] - state.goal["block_pos"]).norm(dim=-1)
    torch.testing.assert_close(r, -dist)  # the dense reward: minus the distance
    draws = env.sample_goal_draws(1000, g)
    assert draws.dtype == torch.int64 and int(draws.min()) == 0 and int(draws.max()) == 3


# ---------------------------------------------------------------- loader, adapter


def _equal(got, want):
    assert type(got) is type(want) or isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_torch_load_trajectory_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "a.npz", **{"observations/state": rng.normal(size=(5, 3)),
                                    "observations/image/front": rng.integers(0, 255, (5, 4, 4, 3)),
                                    "actions": rng.normal(size=(5, 2))})
    with open(tmp_path / "b.pkl", "wb") as f:
        pickle.dump([{"observations": rng.normal(size=(2, 3)), "actions": np.ones((2, 2))},
                     {"observations": rng.normal(size=(3, 3)), "actions": np.zeros((3, 2))}], f)
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump({"observations": rng.normal(size=(4, 3)), "actions": np.ones((4, 2))}, f)
    got, want = list(tgc.load_trajectory_dataset(str(tmp_path))), list(
        jgc.load_trajectory_dataset(str(tmp_path)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _equal(g, w)
    # the two errors: a key that nests under a leaf, and a leaf that is a prefix
    for i, bad in enumerate(({"a": np.zeros(1), "a/b": np.zeros(1)},
                             {"a/b": np.zeros(1), "a": np.zeros(1)})):
        d = tmp_path / f"bad{i}"
        d.mkdir()
        np.savez(d / "t.npz", **bad)
        messages = []
        for loader in (jgc.load_trajectory_dataset, tgc.load_trajectory_dataset):
            with pytest.raises(ValueError) as err:
                list(loader(str(d)))
            messages.append(str(err.value))
        assert messages[0] == messages[1]


class _Timestep:
    def __init__(self, obs, reward, discount, last):
        self.observation, self.reward, self.discount, self._last = obs, reward, discount, last

    def last(self):
        return self._last


class _FakeDM:
    """A dm_env-style env: reward None at reset, a truncating last step at 3
    when `truncate`, else a terminating one (discount 0) at 2."""

    def __init__(self, truncate):
        self.truncate, self.t, self.actions = truncate, 0, []

    def reset(self):
        self.t = 0
        return _Timestep({"pos": np.zeros(3)}, None, 1.0, False)

    def step(self, action):
        self.t += 1
        self.actions.append(np.asarray(action))
        end = 3 if self.truncate else 2
        last = self.t >= end
        discount = 1.0 if (self.truncate or not last) else 0.0
        return _Timestep({"pos": np.full(3, float(self.t))}, 0.5 * self.t, discount, last)


@pytest.mark.parametrize("truncate", [False, True])
def test_torch_dm_env_adapter_matches_jax(truncate):
    envs = {"jax": jgc.DMEnvAdapter(_FakeDM(truncate)), "port": tgc.DMEnvAdapter(_FakeDM(truncate))}
    out = {}
    for name, env in envs.items():
        steps = [env.reset()]
        for a in (np.array([2.0, -3.0, 0.5]), np.zeros(3), np.ones(3)):
            steps.append(env.step(a))
        out[name] = (steps, env._env.actions, env.render())
    (jsteps, jacts, jrender), (tsteps, tacts, trender) = out["jax"], out["port"]
    for js, ts in zip(jsteps, tsteps):
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            _equal(b, a) if isinstance(a, (dict, np.ndarray)) else (type(a) is type(b) and a == b) \
                or pytest.fail(f"{a!r} != {b!r}")
    for a, b in zip(jacts, tacts):
        np.testing.assert_array_equal(a, b)  # clipped to [-1, 1]
    assert jrender is None and trender is None
