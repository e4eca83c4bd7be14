"""The port's pixel DrQ slice end to end against serl_tpu, on the CPU.

`make_drq_sim_experiment(device="cpu", num_envs=4, image_size=32)` (the
full-width small encoders and networks, batch 8, UTD 2, two update_high_utd
calls per iteration) runs 6 loop iterations past its training threshold;
two envs start near their 100-step time limit, so their episodes end and
auto-reset inside the run. Every step is then replayed through serl_tpu's
vmapped pixel env (`_step_state`, `_obs`) from the port's own state
before that step, with the actions the port stored. The stored proprio
state and rewards are held to 1e-3 (tests/test_torch_env.py), dones, masks
and ep_ids exactly, and every stored camera frame, the slot after an
episode end included (the post-reset render), by tests/torch_k2.py's pixel
rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.envs.wrappers import serl_obs as jax_serl_obs
from serl_tpu_torch.training.launcher import make_drq_sim_experiment
from serl_tpu_torch.training.loop import LoopConfig, evaluate, make_fused_loop
from tests import torch_k2

N, ITERS, SIZE, ATOL = 4, 6, 32, 1e-3
KEYS = ("front", "wrist")


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


def _frames_ok(got, want, what):
    failures, summary = torch_k2.pixel_rule(torch.as_tensor(got), torch.from_numpy(np.array(want)))
    assert not failures, (what, failures, summary)


def test_torch_pixel_slice_matches_jax_step_by_step():
    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=0, device="cpu", num_envs=N, image_size=SIZE, batch_size=8, utd_ratio=2,
        updates_per_iter=2, training_starts=0, random_steps=3 * N, buffer_capacity=200)
    assert rb.image_keys == KEYS and not rb.store_next_obs
    carry = init_fn(agent, 0)
    # envs 0 and 1 reach the time limit at iterations 3 and 2
    carry = carry._replace(env_states=carry.env_states._replace(
        t=torch.tensor([97, 98, 0, 50], dtype=torch.int32)))
    before_params = [p.detach().clone() for p in agent.parameters()]
    states, metrics = [carry.env_states], []
    for _ in range(ITERS):
        carry, m = run_chunk(carry, 1)
        states.append(carry.env_states)
        metrics.append(m)
    m = {k: torch.cat([x[k] for x in metrics]) for k in metrics[0]}
    # the learner starts at the insert that reaches batch * utd = 16 rows
    np.testing.assert_array_equal(m["buffer_size"].numpy(), N * np.arange(1, ITERS + 1))
    assert (m["critic_loss"][:3] == 0).all() and (m["critic_loss"][3:] > 0).all()
    assert torch.isfinite(m["actor_loss"]).all() and int(m["ep_count"][-1]) == 2
    assert agent.state.step == 3 * 2 * (2 + 1)  # 3 iterations x 2 calls x (2 critic + 1 actor)
    # every param moved, the encoders' included
    assert all(not torch.equal(p, q) for p, q in zip(agent.parameters(), before_params))
    assert agent.encoder is not None and len(list(agent.encoder.parameters())) == 2 * 12 + 4

    jenv = jpick.PandaPickCubeEnv(image_obs=True, render_size=SIZE)
    jstep = jax.jit(jax.vmap(jenv._step_state))  # physics, reward and done; no render
    jobs = jax.jit(jax.vmap(lambda s: jax_serl_obs(jenv._obs(s))))
    buf = carry.rb_state
    d = buf.data
    ends = 0
    for t in range(ITERS):
        before, after = states[t], states[t + 1]
        want = jobs(_to_jax(before))
        np.testing.assert_allclose(d["observations"]["state"][t].numpy(), np.asarray(want["state"]),
                                   atol=ATOL, rtol=0)
        for k in KEYS:
            _frames_ok(d["observations"][k][t], want[k], f"slot {t} {k}")
        _, jr, jd, _ = jstep(_to_jax(before), jnp.asarray(d["actions"][t].numpy()))
        np.testing.assert_allclose(d["rewards"][t].numpy(), np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d["dones"][t].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(d["masks"][t].numpy(), 1.0 - np.asarray(jd))
        np.testing.assert_array_equal(buf.ep_id[t].numpy(), before.ep_id.numpy() * N + np.arange(N))
        done = np.asarray(jd) > 0.5
        if done.any():
            ends += 1
            np.testing.assert_array_equal(after.t.numpy()[done], 0)
            # the loop's next observation (the buffer's successor slot) is the
            # render of the post-reset state, not the terminal one
            nxt = carry.obs if t + 1 == ITERS else {k: d["observations"][k][t + 1] for k in KEYS}
            fresh = jobs(_to_jax(after))
            for k in KEYS:
                _frames_ok(nxt[k][done], np.asarray(fresh[k])[done], f"reset frame {t} {k}")
    assert ends == 2

    # evaluate's pixel path, over episodes cut to 5 steps to keep the CPU run short
    short = type("ShortEpisodes", (type(env),), {"time_limit_steps": 5})(
        image_obs=True, render_size=SIZE, device="cpu")
    ev = evaluate(short, agent, 0, num_episodes=2, pixel_keys=rb.image_keys)
    assert all(np.isfinite(v) for v in ev.values()) and 0 <= ev["eval/success_rate"] <= 1


def test_torch_pixel_loop_raises_for_stack_histories():
    # the fused loop keeps histories (tests/test_torch_frame_stack.py); the
    # chained fwbw loop acts on one frame, as the JAX package's does, and a
    # stack needs at least one frame
    from serl_tpu_torch.data.replay_buffer import ReplayBuffer
    from serl_tpu_torch.envs.chained_bin import ChainedBinEnv
    from serl_tpu_torch.training.fwbw import FwBwConfig, make_chained_loop

    env, _, rb, config, *_ = make_drq_sim_experiment(device="cpu", num_envs=2, image_size=SIZE,
                                                     buffer_capacity=8, num_stack=2)
    make_fused_loop(env, rb, LoopConfig(num_envs=2))
    with pytest.raises(ValueError, match="num_stack"):
        make_chained_loop(ChainedBinEnv(device="cpu"), rb, FwBwConfig(envs_per_task=1))
    with pytest.raises(ValueError, match="num_stack"):
        ReplayBuffer(rb._example, 8, image_keys=KEYS, num_stack=0, device="cpu")
