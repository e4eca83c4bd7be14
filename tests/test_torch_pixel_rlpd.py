"""The port's pixel RLPD path against serl_tpu's, on the CPU.

- `collect_episodes(pixel_obs=True)` at 32 px, fixed-length and with
  auto-reset (two envs start near their 100-step limit), replayed step by
  step through JAX's vmapped pixel env from the port's own pre-step state:
  the proprio state and rewards to 1e-3 (tests/test_torch_env.py), flags
  and ep_ids exactly, every stored frame (observations, and next
  observations: the next render, or with auto-reset the pre-reset one) by
  tests/torch_k2.py's pixel rule.
- `sample_mixed` over two pixel rings (an online ring that has wrapped and
  a write-once demo ring from `init_from_episodes`, `store_next_obs=False`,
  two cameras, frame stacks T = 1 and 3), with JAX's own index draws:
  exactly equal to JAX's (a gather is a copy), the demo rows at the odd
  positions of an even batch.
- The pixel example: its demo selection keeps what JAX's example keeps; it
  raises on a WorkloadConfig setting it does not read, on another preset,
  and for "resnet-pretrained" without the pickle; it runs end to end at a
  tiny size; the learning check starts it for each seed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data import demos as jdemos
from serl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.wrappers import serl_obs as jax_serl_obs
from serl_tpu_torch.data import demos
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.envs import panda_pick
from serl_tpu_torch.examples import fused_drq_sim, learning_check
from serl_tpu_torch.examples.fused_sac_state_sim import expert_demo_policy
from tests import torch_k2
from tests.test_torch_pixel_slice import _to_jax
from tests.test_torch_rlpd import _jax_draws

N, SIZE, ATOL = 3, 32, 1e-3
KEYS = ("front", "wrist")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames_ok(got, want, what):
    failures, summary = torch_k2.pixel_rule(torch.as_tensor(got), torch.from_numpy(np.array(want)))
    assert not failures, (what, failures, summary)


@pytest.mark.parametrize("auto_reset", [False, True])
def test_torch_pixel_collect_episodes_replays_through_jax(auto_reset, monkeypatch):
    env = panda_pick.PandaPickCubeEnv(image_obs=True, render_size=SIZE, device="cpu")
    if auto_reset:  # envs 0 and 1 reach the time limit at steps 2 and 1
        reset = env.reset

        def near_the_limit(n, generator):
            states, obs = reset(n, generator)
            return states._replace(t=torch.tensor([97, 98, 10], dtype=torch.int32)), obs

        monkeypatch.setattr(env, "reset", near_the_limit)
    seen = []

    def policy(states, generator):
        seen.append(states)
        return expert_demo_policy(states, generator)

    steps = 4
    trs = demos.collect_episodes(env, policy, torch.Generator().manual_seed(5), N,
                                 episode_len=steps, pixel_obs=True, auto_reset=auto_reset)
    assert set(trs["observations"]) == {"state", *KEYS}
    assert trs["observations"]["front"].shape == (N * steps, SIZE, SIZE, 3)
    assert trs["observations"]["front"].dtype == torch.uint8
    jenv = jpick.PandaPickCubeEnv(image_obs=True, render_size=SIZE)
    jstep = jax.jit(jax.vmap(jenv.step_auto_reset if auto_reset else jenv.step))
    jobs = jax.jit(jax.vmap(lambda s: jax_serl_obs(jenv._obs(s))))
    per_step = lambda x: x.numpy().reshape((N, steps) + tuple(x.shape[1:]))
    d = jax.tree.map(per_step, trs)
    ends = 0
    for t in range(steps):
        js = _to_jax(seen[t])
        want = jobs(js)
        np.testing.assert_allclose(d["observations"]["state"][:, t], np.asarray(want["state"]),
                                   atol=ATOL, rtol=0)
        _, jo, jr, jd, ji = jstep(js, jnp.asarray(d["actions"][:, t]))
        np.testing.assert_allclose(d["rewards"][:, t], np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(d["dones"][:, t], np.asarray(jd))
        np.testing.assert_array_equal(d["success"][:, t], np.asarray(ji["success"]))
        nxt = jax_serl_obs(ji["final_obs"]) if auto_reset else jax_serl_obs(jo)
        np.testing.assert_allclose(d["next_observations"]["state"][:, t], np.asarray(nxt["state"]),
                                   atol=ATOL, rtol=0)
        for k in KEYS:
            _frames_ok(d["observations"][k][:, t], want[k], f"obs {t} {k}")
            _frames_ok(d["next_observations"][k][:, t], nxt[k], f"next_obs {t} {k}")
        want_ep = (seen[t].ep_id.numpy() * N + np.arange(N)) if auto_reset else np.arange(N)
        np.testing.assert_array_equal(d["ep_ids"][:, t], want_ep)
        ends += int(np.asarray(jd).sum())
    assert ends == (2 if auto_reset else 0)


# ---------------------------------------------------------------- two pixel rings

SLOTS, STREAMS, DEMO_STREAMS, DEMO_LEN = 10, 4, 3, 6


def _example():
    return {"observations": {"state": np.zeros(3, np.float32),
                             **{k: np.zeros((6, 5, 3), np.uint8) for k in KEYS}},
            "actions": np.zeros(2, np.float32), "rewards": np.float32(0),
            "masks": np.float32(0), "dones": np.float32(0)}


def _rows(rng, n):
    return {"observations": {"state": rng.normal(size=(n, 3)).astype(np.float32),
                             **{k: rng.integers(0, 256, (n, 6, 5, 3), dtype=np.uint8)
                                for k in KEYS}},
            "actions": rng.normal(size=(n, 2)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": np.ones(n, np.float32), "dones": np.zeros(n, np.float32)}


def _equal(got, want, path="batch"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)
    assert got.numpy().dtype == np.asarray(want).dtype, path


@pytest.mark.parametrize("num_stack", [1, 3])
@pytest.mark.parametrize("batch", [8, 12])  # 8: the online half aligned; 12: the demo half
def test_torch_pixel_sample_mixed_matches_jax(batch, num_stack):
    ex = _example()
    kw = dict(store_next_obs=False, image_keys=KEYS, num_stack=num_stack)
    jrb = JaxReplayBuffer(jax.tree.map(jnp.asarray, ex), SLOTS * STREAMS, **kw)
    trb = ReplayBuffer(jax.tree.map(torch.as_tensor, ex), SLOTS * STREAMS, device="cpu", **kw)
    rng = np.random.default_rng(num_stack)
    ja, ta = jrb.init_state(STREAMS), trb.init_state(STREAMS)
    for t in range(13):  # past a wrap; episodes of 4 steps in stream 0, 3 elsewhere
        tr = _rows(rng, STREAMS)
        ep = (np.array([t // 4] + [t // 3] * (STREAMS - 1), np.int32) * STREAMS
              + np.arange(STREAMS, dtype=np.int32))
        ja = jrb.insert(ja, jax.tree.map(jnp.asarray, tr), jnp.asarray(ep))
        ta = trb.insert(ta, jax.tree.map(torch.from_numpy, tr), torch.from_numpy(ep))
    demo = _rows(rng, DEMO_STREAMS * DEMO_LEN)
    ep = np.repeat(np.arange(DEMO_STREAMS, dtype=np.int32), DEMO_LEN)
    jb = jrb.init_from_episodes(jax.tree.map(jnp.asarray, demo), jnp.asarray(ep), DEMO_LEN)
    tb = trb.init_from_episodes(demo, ep, DEMO_LEN)
    key = jax.random.PRNGKey(batch + num_stack)
    want = jrb.sample_mixed(ja, jb, key, batch)
    ka, kb = jax.random.split(key)
    u_a, e_a = _jax_draws(ka, ja, batch // 2, store_next_obs=False)
    u_b, e_b = _jax_draws(kb, jb, batch - batch // 2, store_next_obs=False)
    got = trb.sample_mixed(ta, tb, batch, u_a=u_a, e_a=e_a, u_b=u_b, e_b=e_b)
    _equal(got, want)
    assert got["observations"]["front"].shape == (batch, num_stack, 6, 5, 3)
    demo_states = {tuple(r) for r in tb.data["observations"]["state"].reshape(-1, 3).tolist()}
    from_demo = [tuple(r) in demo_states for r in got["observations"]["state"].tolist()]
    assert from_demo == [i % 2 == 1 for i in range(batch)]


# ---------------------------------------------------------------- the example


def _transitions(episodes=5, length=4, seed=0):
    rng = np.random.default_rng(seed)
    n = episodes * length
    success = np.zeros((episodes, length), np.float32)
    success[[1, 3, 4], 2:] = 1.0
    obs = lambda: {"state": rng.normal(size=(n, 7)).astype(np.float32),
                   **{k: rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8) for k in KEYS}}
    return {"observations": obs(), "next_observations": obs(),
            "actions": rng.normal(size=(n, 4)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": np.ones(n, np.float32), "dones": np.zeros(n, np.float32),
            "success": success.reshape(-1),
            "ep_ids": np.repeat(np.arange(episodes, dtype=np.int32), length)}


def test_torch_pixel_example_selects_the_demos_jax_selects(monkeypatch):
    """num_demos + 10 expert episodes with pixel obs from a generator seeded
    with seed + 7; next_observations dropped; select_demo_episodes on the
    device (JAX's example); the count of successful episodes."""
    tr = _transitions()
    calls = []

    def collect(env, policy, generator, num_episodes, episode_len, pixel_obs):
        calls.append((policy, generator.initial_seed(), num_episodes, episode_len, pixel_obs))
        return jax.tree.map(torch.from_numpy, tr)

    monkeypatch.setattr(fused_drq_sim, "collect_episodes", collect)
    kept, succeeded = fused_drq_sim.scripted_pixel_demos(types.SimpleNamespace(device="cpu"),
                                                         seed=3, num_demos=2, episode_len=4)
    assert calls == [(expert_demo_policy, 10, 12, 4, True)] and succeeded == 3
    jt = jax.tree.map(jnp.asarray, {k: v for k, v in tr.items() if k != "next_observations"})
    _equal(kept, jdemos.select_demo_episodes(jt, 2, 4), "kept")


@pytest.mark.parametrize("argv", [["--preset", "state_sim"], ["--algo", "sac"],
                                  ["--discount", "0.99"], ["--critic_ensemble_size", "4"],
                                  ["--temperature_init", "0.1"], ["--port", "6000"],
                                  ["--publish_period", "3"]])
def test_torch_pixel_example_raises_on_a_setting_it_does_not_read(argv):
    with pytest.raises(ValueError, match="refused, not ignored"):
        fused_drq_sim.main(["--rlpd", "--device", "cpu"] + argv)


def test_torch_pixel_example_needs_the_pickle_for_resnet_pretrained(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(tmp_path / "nope.pkl"))
    with pytest.raises(FileNotFoundError):
        fused_drq_sim.main(["--encoder_type", "resnet-pretrained", "--device", "cpu",
                            "--num_envs", "2", "--image_size", "32", "--buffer_capacity", "8"])


def test_torch_pixel_example_runs_rlpd_end_to_end(tmp_path, monkeypatch):
    """`--rlpd` at a tiny size: the demo ring from the (stubbed, 4-step)
    expert episodes, the learner past its threshold on half-demo batches,
    an evaluation per chunk (episodes cut to 3 steps)."""
    length = 100  # the example's episode length; the stub fills it from 4 steps
    tr = _transitions(episodes=12, length=4, seed=1)
    sized = {k: (np.repeat(v, length // 4, axis=0) if not isinstance(v, dict)
                 else {kk: np.repeat(vv, length // 4, axis=0) for kk, vv in v.items()})
             for k, v in tr.items()}
    sized["ep_ids"] = np.repeat(np.arange(12, dtype=np.int32), length)
    sized["success"] = np.repeat(tr["success"].reshape(12, 4).max(1), length)
    for part in ("observations", "next_observations"):
        for k in KEYS:
            sized[part][k] = (np.zeros((12 * length, 32, 32, 3), np.uint8)
                              + sized[part][k][:, :1, :1])
    monkeypatch.setattr(fused_drq_sim, "collect_episodes",
                        lambda *a, **kw: jax.tree.map(torch.from_numpy, sized))
    monkeypatch.setattr(panda_pick.PandaPickCubeEnv, "time_limit_steps", 3)
    carry, best = fused_drq_sim.main(
        ["--rlpd", "--device", "cpu", "--num_envs", "2", "--num_demos", "2", "--image_size", "32",
         "--total_env_steps", "16", "--chunk_iters", "4", "--eval_period_chunks", "1",
         "--eval_episodes", "2", "--training_starts", "4", "--batch_size", "4", "--utd_ratio", "2",
         "--updates_per_iter", "1", "--random_steps", "4", "--buffer_capacity", "40",
         "--log_dir", str(tmp_path)])
    assert carry.demo_state is not None and carry.demo_state.ep_id.shape == (length, 2)
    assert carry.env_steps == 16 and carry.agent.state.step > 0
    assert best["params"] is not None


def test_torch_learning_check_starts_the_pixel_example(tmp_path, monkeypatch):
    started = []

    class Proc:
        def __init__(self, cmd, **kw):
            started.append(cmd)

        def wait(self):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(learning_check, "card_line", lambda: "card, 700 W")
    monkeypatch.setattr(learning_check.subprocess, "Popen", Proc)
    assert learning_check.main(["--out", str(tmp_path), "--example", "fused_drq_sim",
                                "--seeds", "0", "1", "--total_env_steps", "96000",
                                "--success_stop", "0.9"]) == 0
    assert [c[2:] for c in started] == [
        ["serl_tpu_torch.examples.fused_drq_sim", "--rlpd", "--preset", "drq_rlpd", "--seed",
         str(s), "--total_env_steps", "96000", "--success_stop", "0.9", "--log_dir",
         str(tmp_path / f"seed{s}")] for s in (0, 1)]
