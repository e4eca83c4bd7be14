"""The port's actor slice end to end against serl_tpu, on the CPU.

`make_state_sim_experiment(device="cpu", num_envs=8)` runs 105 loop
iterations: 50 with random actions, 55 with policy samples, across the
100-step episode end. Every step is then replayed through serl_tpu's vmapped
`step_auto_reset` from the port's own state before that step (re-synced each
step, so float32 drift cannot hide a fault), with the actions the port
stored. The port's reset positions are read off its post-reset states and
the JAX reset state is built from `engine.init_state(xy)`. Stored obs,
next_obs, rewards, dones, masks and ep_ids are compared; observations and
rewards to 1e-3 (see tests/test_torch_env.py), flags and ids exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.training.launcher import make_state_sim_experiment
from serl_tpu_torch.training.loop import LoopConfig, evaluate, make_fused_loop

N, ITERS, ATOL = 8, 105, 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _to_jax(state):
    return jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in state.physics)),
        t=jnp.asarray(state.t.numpy()),
        z_init=jnp.asarray(state.z_init.numpy()),
        rng=jax.random.split(jax.random.PRNGKey(0), state.t.shape[0]),
        ep_id=jnp.asarray(state.ep_id.numpy()),
    )


def test_torch_actor_slice_matches_jax_step_by_step():
    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=0, device="cpu", num_envs=N, random_steps=50 * N, buffer_capacity=1000)
    carry = init_fn(agent, 0)
    states, metrics = [carry.env_states], []
    for _ in range(ITERS):
        carry, m = run_chunk(carry, 1)
        states.append(carry.env_states)
        metrics.append(m)
    buf = carry.rb_state
    assert buf.size == ITERS and int(metrics[-1]["buffer_size"][0]) == ITERS * N
    assert int(metrics[-1]["env_steps"][0]) == ITERS * N
    assert int(metrics[-1]["ep_count"][0]) == N  # every env finished one episode

    jenv = jpick.PandaPickCubeEnv()
    jauto = jax.jit(jax.vmap(jenv.step_auto_reset))
    jobs = jax.jit(jax.vmap(lambda s: jpick.flatten_obs(jenv._obs(s))))
    d = {k: v.numpy() for k, v in buf.data.items()}
    episode_ends = 0
    for t in range(ITERS):
        before, after = states[t], states[t + 1]
        js = _to_jax(before)
        np.testing.assert_allclose(d["observations"][t], np.asarray(jobs(js)), atol=ATOL, rtol=0)
        _, jo, jr, jd, ji = jauto(js, jnp.asarray(d["actions"][t]))
        np.testing.assert_allclose(d["rewards"][t], np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d["dones"][t], np.asarray(jd))
        np.testing.assert_array_equal(d["masks"][t], 1.0 - np.asarray(jd))
        np.testing.assert_allclose(d["next_observations"][t],
                                   np.asarray(jpick.flatten_obs(ji["final_obs"])), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(buf.ep_id[t].numpy(),
                                      before.ep_id.numpy() * N + np.arange(N))
        done = np.asarray(jd) > 0.5
        if done.any():
            episode_ends += 1
            # the port reset these envs at its own xy: JAX's reset state there
            xy = after.physics.cube_pos[:, :2].numpy()
            fresh = jax.vmap(jengine.init_state)(jnp.asarray(xy))
            fresh_obs = np.asarray(jobs(_to_jax(after)._replace(physics=fresh)))
            np.testing.assert_allclose(carry_obs(states, t + 1, env)[done], fresh_obs[done],
                                       atol=1e-6, rtol=0)
            np.testing.assert_array_equal(after.t.numpy()[done], 0)
            np.testing.assert_array_equal(after.ep_id.numpy()[done], before.ep_id.numpy()[done] + 1)
        keep = ~done
        np.testing.assert_allclose(carry_obs(states, t + 1, env)[keep],
                                   np.asarray(jpick.flatten_obs(jo))[keep], atol=ATOL, rtol=0)
    assert episode_ends == 1  # step 100 ends every env's first episode
    actions = d["actions"]
    assert np.abs(actions).max() <= 1.0 and not np.allclose(actions[50:], actions[50:].mean())


def carry_obs(states, i, env):
    from serl_tpu_torch.envs.panda_pick import flatten_obs

    return flatten_obs(env._obs(states[i])).numpy()


def test_torch_loop_raises_where_the_slice_ends():
    # the learner runs: the insert of iteration 2 reaches the training
    # threshold of 8 rows, and from then on the loss metrics are non-zero
    _, agent, _, _, init_fn, run_chunk = make_state_sim_experiment(
        device="cpu", num_envs=4, training_starts=8, batch_size=2, utd_ratio=1,
        buffer_capacity=64)
    carry, metrics = run_chunk(init_fn(agent, 0), 3)
    for k in ("critic_loss", "actor_loss", "temperature", "entropy"):
        assert metrics[k][0] == 0 and (metrics[k][1:] != 0).all(), k
        assert torch.isfinite(metrics[k]).all(), k
    assert agent.state.step == 2 * 2  # 2 learner iterations x (1 critic + 1 actor update)
    env, _, rb, config, *_ = make_state_sim_experiment(device="cpu", num_envs=4)
    with pytest.raises(ValueError, match="intervention_mode"):
        make_fused_loop(env, rb, config._replace(intervention_mode="sometimes"))
    # the loop takes pixel rings that store next observations, and stacks
    # (tests/test_torch_frame_stack.py), and any env under data parallelism
    # (tests/test_torch_fwbw_isolated.py holds the pose env's draws)
    stacked_rb = ReplayBuffer({"observations": {"front": torch.zeros((4, 4, 3), dtype=torch.uint8)}},
                              8, store_next_obs=False, image_keys=("front",), num_stack=2,
                              device="cpu")
    make_fused_loop(env, stacked_rb, LoopConfig(num_envs=4))
    from serl_tpu_torch.distributed.sharding import DataParallel
    from serl_tpu_torch.envs.tasks import PandaPoseTaskEnv

    dp = DataParallel(rank=0, world_size=2, backend="gloo", device=torch.device("cpu"))
    make_fused_loop(PandaPoseTaskEnv(device="cpu"), rb, LoopConfig(num_envs=4), dp=dp)


def test_torch_evaluate_runs_full_argmax_episodes():
    env, agent, *_ = make_state_sim_experiment(device="cpu", num_envs=2)
    from serl_tpu_torch.envs.physics import engine

    before = engine.control_step.launches
    out = evaluate(env, agent, 0, num_episodes=2)
    assert engine.control_step.launches == before  # CPU: the plain version
    assert set(out) == {"eval/return_mean", "eval/success_rate"}
    assert 0.0 <= out["eval/return_mean"] <= 100.0 and out["eval/success_rate"] in (0.0, 0.5, 1.0)
