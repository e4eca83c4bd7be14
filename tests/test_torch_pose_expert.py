"""The pose expert, the state bank and demo collection over the pose env,
against serl_tpu, on the CPU.

- `pose_expert_action` on the states of a port rollout of the expert (the
  approach above the target and the descent) against JAX's vmapped expert
  on the same states, both in float64 (JAX under `jax.enable_x64`; model
  constants may round differently, 3e-8 measured): actions to 1e-6 in every env whose xy error lies more than 1e-4 from the 5 mm
  alignment threshold; and with one (7,) noise vector for every env, JAX's
  own draw. In float32 the rotation part is ill-conditioned at the task's
  orientation (w and z of the measured quaternion near 0, where
  mat_to_quat takes them from square roots of rounding-sized numbers: the
  two frameworks' float32 actions differ by up to ~1.3e-4 there), so the
  port's float32 actions are held to its float64 ones within 1e-3 (5.3e-4
  measured) and its
  translation and gripper parts to JAX's float32 ones at 1e-5.
- `collect_episodes` over the pose env with auto-reset, 7-dim actions:
  every stored step replayed through JAX's `_step_state` and `_obs` from the
  port's own pre-step state (re-synced each step): observations and rewards
  to 1e-3 (one physics step apart: tests/test_torch_env.py), the tcp pose's
  angles modulo 2 pi, flags and ep_ids exactly; an ended env's next
  observation is its reset state's. With `pixel_obs` the SERL pixel layout
  (10-dim proprio, two uint8 frames) under tests/torch_k2.py's pixel rule.
- `collect_state_bank`: the pre-step states in JAX's time-major layout (JAX's
  own function run on a counting env shows the order).
- The peg example's demo ring: one stream per demo stream, auto-reset
  episode ids, 7-dim actions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data import demos as jdemos
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import scripted_expert as jexpert
from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs.wrappers import serl_obs as jserl_obs
from serl_tpu_torch.data import demos
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.envs.panda_pick import EnvState
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.scripted_expert import pose_expert_action
from serl_tpu_torch.examples import fused_peg_insert
from tests import torch_k2
from tests.torch_pose_jax import angle_error, to_jax

N, STEPS, LIMIT, ATOL, MARGIN = 3, 12, 10, 1e-3, 1e-4
CFG = tasks.PEG_INSERT_CONFIG._replace(time_limit_steps=LIMIT)
JCFG = jtasks.PEG_INSERT_CONFIG._replace(time_limit_steps=LIMIT)
ANGLES = slice(7, 10)  # the tcp pose's Euler angles in the flat (sorted-key) observation


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _recording(policy):
    seen = []

    def fn(states, generator):
        seen.append(states)
        return policy(states, generator)

    return fn, seen


def _expert(states, generator=None):
    return pose_expert_action(states, CFG.target_pose, CFG.action_scale)


@pytest.fixture(scope="module")
def expert_rollout():
    torch.set_num_threads(1)
    env = tasks.PandaPoseTaskEnv(CFG, device="cpu")
    policy, seen = _recording(_expert)
    trs = demos.collect_episodes(env, policy, torch.Generator().manual_seed(5), N,
                                 episode_len=STEPS, auto_reset=True)
    return env, trs, seen


def _cat(states):
    cat = lambda xs: torch.cat(list(xs))
    return EnvState(engine.PhysicsState(*map(cat, zip(*(s.physics for s in states)))),
                    *(cat(getattr(s, f) for s in states) for f in ("t", "z_init", "ep_id")))


def test_torch_pose_expert_matches_jax(expert_rollout):
    env, _, seen = expert_rollout
    states = _cat(seen)
    f64 = type(states)(type(states.physics)(*(x.double() for x in states.physics)), *states[1:])
    tcp = engine.fk(states.physics.qpos).pinch_pos.numpy()
    jexp = jax.jit(jax.vmap(jexpert.pose_expert_action, in_axes=(0, None, None)))
    # the task's target (the approach), then targets 2 mm from a few states'
    # own tcp (those states aligned: the descent)
    targets = [np.asarray(CFG.target_pose)] + [
        np.r_[tcp[k, :2] + [0.002, -0.001], CFG.target_pose[2:]] for k in (0, 7, 20, 33)]
    aligned = 0
    for target in targets:
        xy_err = np.sqrt(((tcp[:, :2] - target[:2]) ** 2).sum(-1))
        far = np.abs(xy_err - 0.005) > MARGIN
        assert far.mean() >= 0.9
        aligned += int((xy_err[far] < 0.005).sum())
        with jax.enable_x64(True):
            want = np.asarray(jexp(to_jax(f64), jnp.asarray(target, jnp.float32),
                                   jnp.asarray(JCFG.action_scale)))
        assert want.dtype == np.float64
        got = pose_expert_action(f64, target, CFG.action_scale).numpy()
        np.testing.assert_allclose(got[far], want[far], atol=1e-6, rtol=0)
        got32 = pose_expert_action(states, target, CFG.action_scale).numpy()
        np.testing.assert_allclose(got32, got, atol=1e-3, rtol=0)
        want32 = np.asarray(jexp(to_jax(states), jnp.asarray(target, jnp.float32),
                                 jnp.asarray(JCFG.action_scale)))
        moves = [0, 1, 2, 6]  # the translation and the gripper: no mat_to_quat
        np.testing.assert_allclose(got32[far][:, moves], want32[far][:, moves], atol=1e-5, rtol=0)
        assert got32.shape[1] == 7 and np.abs(got32).max() <= 1.0 and (got32[:, 6] == 0).all()
    assert aligned >= 4
    # one noise vector for every env (the JAX examples' vmap with in_axes=(0, None))
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(11)
        target = jnp.asarray(JCFG.target_pose)
        want = np.asarray(jax.vmap(lambda s, k: jexpert.pose_expert_action(
            s, target, jnp.asarray(JCFG.action_scale), k, noise_scale=0.1),
            in_axes=(0, None))(to_jax(f64), key))
        noise = torch.tensor(np.asarray(0.1 * jax.random.normal(key, (7,))))
    got = pose_expert_action(f64, CFG.target_pose, CFG.action_scale, noise).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _assert_flat_obs(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    rest = np.r_[0:7, 10:13]
    np.testing.assert_allclose(got[..., rest], want[..., rest], atol=atol, rtol=0)
    assert angle_error(got[..., ANGLES], want[..., ANGLES]).max() <= atol


def test_torch_collect_episodes_over_the_pose_env_replays_through_jax(expert_rollout):
    env, trs, seen = expert_rollout
    assert trs["observations"].shape == (N * STEPS, tasks.STATE_OBS_DIM)
    assert trs["actions"].shape == (N * STEPS, 7)
    jenv = jtasks.PandaPoseTaskEnv(JCFG)
    jstep = jax.jit(jax.vmap(jenv._step_state))
    jobs = jax.jit(jax.vmap(lambda s: jpick.flatten_obs(jenv._obs(s))))
    d = {k: v.numpy().reshape((N, STEPS) + tuple(v.shape[1:])) for k, v in trs.items()}
    resets = 0
    for t in range(STEPS):
        before = seen[t]
        js = to_jax(before)
        _assert_flat_obs(d["observations"][:, t], jobs(js))
        stepped, jr, jd, ji = jstep(js, jnp.asarray(d["actions"][:, t]))
        np.testing.assert_allclose(d["rewards"][:, t], np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d["dones"][:, t], np.asarray(jd))
        np.testing.assert_array_equal(d["masks"][:, t], 1.0 - np.asarray(jd))
        np.testing.assert_array_equal(d["success"][:, t], np.asarray(ji["success"]))
        _assert_flat_obs(d["next_observations"][:, t], jobs(stepped))
        np.testing.assert_array_equal(d["ep_ids"][:, t], before.ep_id.numpy() * N + np.arange(N))
        done = np.asarray(jd) > 0.5
        if done.any() and t + 1 < STEPS:
            resets += 1
            after = seen[t + 1]
            fresh = demos.flatten_obs(env._obs(after)).numpy()
            np.testing.assert_array_equal(d["observations"][done, t + 1], fresh[done])
            np.testing.assert_array_equal(after.ep_id.numpy()[done], before.ep_id.numpy()[done] + 1)
            np.testing.assert_array_equal(after.t.numpy()[done], 0)
    assert resets >= 1  # the 10-step time limit, or an early success


def test_torch_collect_pixel_episodes_over_the_pose_env_matches_jax():
    env = tasks.PandaPoseTaskEnv(CFG, image_obs=True, render_size=32, device="cpu")
    policy, seen = _recording(_expert)
    trs = demos.collect_episodes(env, policy, torch.Generator().manual_seed(6), 2, episode_len=3,
                                 pixel_obs=True, auto_reset=True)
    assert sorted(trs["observations"]) == ["front", "state", "wrist"]
    assert trs["observations"]["state"].shape == (6, tasks.PIXEL_STATE_DIM)
    assert trs["observations"]["front"].shape == (6, 32, 32, 3)
    assert trs["observations"]["front"].dtype == torch.uint8 and trs["actions"].shape == (6, 7)
    jenv = jtasks.PandaPoseTaskEnv(JCFG, image_obs=True, render_size=32)
    want = jax.jit(jax.vmap(lambda s: jserl_obs(jenv._obs(s))))(to_jax(seen[1]))
    got = {k: v.reshape((2, 3) + tuple(v.shape[1:]))[:, 1] for k, v in trs["observations"].items()}
    np.testing.assert_allclose(got["state"][:, :7].numpy(), np.asarray(want["state"])[:, :7],
                               atol=1e-5, rtol=0)  # gripper, tcp position and ...
    assert angle_error(got["state"][:, 4:7], np.asarray(want["state"])[:, 4:7]).max() <= 1e-5
    for k in ("front", "wrist"):
        failures, _ = torch_k2.pixel_rule(got[k], torch.from_numpy(np.array(want[k])))
        assert not failures, (k, failures)


class _CountingEnv:
    """A JAX env whose state counts its steps, to read a bank's layout."""

    def reset(self, key):
        return jnp.zeros((), jnp.int32), None

    def step_auto_reset(self, state, action):
        return state + 1, None, 0.0, 0.0, {}


def test_torch_collect_state_bank_records_pre_step_states_in_jax_layout():
    env = tasks.PandaPoseTaskEnv(CFG, device="cpu")
    policy, seen = _recording(_expert)
    streams, steps = 2, 3
    bank = demos.collect_state_bank(env, policy, torch.Generator().manual_seed(7),
                                    num_streams=streams, steps=steps)
    jbank = jdemos.collect_state_bank(_CountingEnv(), lambda s, k: jnp.zeros((s.shape[0], 7)),
                                      jax.random.PRNGKey(0), num_streams=streams, steps=steps)
    order = np.asarray(jbank)  # the step each bank row was recorded at
    np.testing.assert_array_equal(order, np.repeat(np.arange(steps), streams))
    assert bank.t.shape == (streams * steps,)
    for row, t in enumerate(order):
        i = row % streams
        for f in bank.physics._fields:
            assert torch.equal(getattr(bank.physics, f)[row], getattr(seen[t].physics, f)[i]), f
    np.testing.assert_array_equal(bank.t.numpy(), order)  # no episode ends in 3 steps
    env.set_demo_reset_bank(bank, 1.0)
    state = env._reset_state(env.sample_reset_draws(2, torch.Generator().manual_seed(8)))
    assert (state.physics.qpos[:, None] == bank.physics.qpos[None]).all(-1).any(1).all()


def test_torch_peg_example_demo_ring():
    env = tasks.PandaPoseTaskEnv(CFG._replace(time_limit_steps=4), device="cpu")
    ring, successes, episodes = fused_peg_insert.expert_demos(
        env, fused_peg_insert.pose_expert(CFG), seed=0, num_demos=2)
    assert ring.ep_id.shape == (4, 2) and (ring.size, ring.insert_slot) == (4, 0)
    assert ring.data["actions"].shape == (4, 2, 7)
    assert ring.data["observations"].shape == (4, 2, tasks.STATE_OBS_DIM)
    assert episodes == 2 and 0 <= successes <= episodes  # one 4-step episode per stream
    np.testing.assert_array_equal(ring.ep_id.numpy(), [[0, 1]] * 4)
