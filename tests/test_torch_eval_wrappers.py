"""The evaluation helpers and the wrapper helpers against serl_tpu's, on
the CPU.

- `flatten_info` exactly; `supply_rng` hands every call one generator that
  advances; the gym-API `evaluate` and `evaluate_with_trajectories` over a
  scripted numpy env (episodes of different lengths, nested final infos)
  under one policy: equal dicts and trajectories; `bootstrap_std` with the
  resampling indices numpy's global state gives the JAX function: equal.
- `act_exec_step` against JAX's vmapped over the same envs: over a
  scripted clock env in both frameworks (the last sub-step's reward, done
  the OR over the chunk, success the maximum) exactly, at chunk lengths 1-3;
  over the batched pick env with both frameworks' physics the identity (as
  tests/test_torch_tasks.py does) to 1e-5 abs.
- `front_camera_obs`, `gripper_close_action`, `z_only_action`,
  `unnormalize_action`, `normalize_proprio`, `remap_obs` exactly;
  `adjoint_matrix` to 1e-6; `pose_relative_to` for a batch of poses in one
  frame and for one pose: positions to 1e-6, the relative rotation's Euler
  angles modulo 2 pi to 1e-5 (a roll at the +-pi flip takes either sign).
- `common/typing.py`'s aliases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.common import evaluation as jeval
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import wrappers as jw
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.common import evaluation
from serl_tpu_torch.common import typing as ttyping
from serl_tpu_torch.envs import wrappers
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.envs.physics import engine
from tests.torch_pose_jax import to_torch

ANGLE_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_torch_flatten_info_and_supply_rng():
    d = {"a": 1, "b": {"c": 2.0, "d": {"e": np.zeros(3)}}, "f": "x"}
    got, want = evaluation.flatten_info(d, "final"), jeval.flatten_info(d, "final")
    assert list(got) == list(want) and all(got[k] is want[k] for k in want)
    assert evaluation.flatten_info(d, sep="/").keys() == jeval.flatten_info(d, sep="/").keys()
    calls = []

    def f(x, *, generator):
        calls.append(generator)
        return torch.rand((), generator=generator) + x

    g = torch.Generator().manual_seed(3)
    wrapped = evaluation.supply_rng(f, g)
    a, b = wrapped(0.0), wrapped(0.0)
    assert calls == [g, g] and float(a) != float(b)
    again = evaluation.supply_rng(f, torch.Generator().manual_seed(3))
    assert float(again(0.0)) == float(a)
    np.random.seed(0)
    assert isinstance(float(evaluation.supply_rng(f)(1.0)), float)


class _ScriptedEnv:
    """A numpy gym-API env: episode k lasts 2 + k % 3 steps; reward = the
    action's sum; the final info nests scalars and an array."""

    def __init__(self):
        self.k, self.t = -1, 0

    def reset(self):
        self.k, self.t = self.k + 1, 0
        return np.array([self.k, 0.0], np.float32), {}

    def step(self, action):
        self.t += 1
        last = self.t >= 2 + self.k % 3
        info = {"success": float(last and self.k % 2 == 0),
                "episode": {"r": float(self.t), "l": self.t}, "frames": np.zeros(2)}
        obs = np.array([self.k, self.t], np.float32)
        return obs, float(np.sum(action)), last and self.k % 2 == 0, last and self.k % 2 == 1, info


def _policy(obs):
    return np.array([0.1 * obs[0], -0.2 * obs[1]], np.float32)


def test_torch_gym_loop_evaluations_match_jax():
    want = jeval.evaluate(_policy, _ScriptedEnv(), 5)
    got = evaluation.evaluate(_policy, _ScriptedEnv(), 5)
    assert got == want and "final.success" in got and "final.episode.l" in got
    (gs, gt), (ws, wt) = (evaluation.evaluate_with_trajectories(_policy, _ScriptedEnv(), 4),
                          jeval.evaluate_with_trajectories(_policy, _ScriptedEnv(), 4))
    assert gs == ws and len(gt) == len(wt) == 4
    for a, b in zip(gt, wt):
        assert a.keys() == b.keys() and a["reward"] == b["reward"] and a["done"] == b["done"]
        for x, y in zip(a["observation"], b["observation"]):
            np.testing.assert_array_equal(x, y)


def test_torch_bootstrap_std_matches_jax():
    arr = np.random.default_rng(0).normal(size=17)
    np.random.seed(4)
    want = jeval.bootstrap_std(arr, n=30)
    np.random.seed(4)
    indices = [np.random.choice(len(arr), len(arr)) for _ in range(30)]
    assert evaluation.bootstrap_std(arr, n=30, indices=indices) == want
    np.random.seed(4)
    assert evaluation.bootstrap_std(arr, n=30) == want
    assert evaluation.bootstrap_std(arr, f=np.median) >= 0.0


class _JaxClockEnv:
    """One env: the state a clock; reward = the clock + the action's sum,
    done from the clock's limit, success at clock 2 only."""

    def step(self, t, action):
        t = t + 1
        r = t.astype(jnp.float32) + action.sum()
        return t, {"t": t}, r, (t >= 3).astype(jnp.float32), {
            "success": (t == 2).astype(jnp.float32)}


class _TorchClockEnv:
    """The same env, batched."""

    def step(self, t, action):
        t = t + 1
        r = t.to(torch.float32) + action.sum(-1)
        return t, {"t": t}, r, (t >= 3).to(torch.float32), {"success": (t == 2).to(torch.float32)}


def test_torch_act_exec_step_matches_jax():
    """The chunk's sub-actions in turn: the last sub-step's reward, done the
    OR over the chunk, success the maximum (as JAX's lax.scan, vmapped)."""
    t0 = np.array([0, 1, 2, 5], np.int32)
    for horizon in (1, 2, 3):
        chunk = np.random.default_rng(horizon).uniform(-1, 1, (4, horizon, 2)).astype(np.float32)
        ws, wobs, wr, wd, winfo = jax.vmap(lambda s, a: jw.act_exec_step(_JaxClockEnv(), s, a))(
            jnp.asarray(t0), jnp.asarray(chunk))
        gs, gobs, gr, gd, ginfo = wrappers.act_exec_step(_TorchClockEnv(), torch.from_numpy(t0),
                                                         torch.from_numpy(chunk))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gobs["t"].numpy(), np.asarray(wobs["t"]))
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-6)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(ginfo["success"].numpy(), np.asarray(winfo["success"]))
    assert gd.tolist() == [1.0, 1.0, 1.0, 1.0] and ginfo["success"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_torch_act_exec_step_over_the_pick_env_matches_jax(monkeypatch):
    """Over the batched pick env (both frameworks' control step the identity,
    as tests/test_torch_tasks.py does): the mocap, clock, reward, done and
    observations after a 4-step chunk."""
    monkeypatch.setattr(engine, "control_step", lambda p, obstacles=None: p)
    monkeypatch.setattr(jengine, "control_step", lambda p, obstacles=None: p)
    n, horizon = 3, 4
    env = PandaPickCubeEnv(device="cpu")
    jenv = jpick.PandaPickCubeEnv()
    jstates, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), n))
    jstates = jstates._replace(t=jnp.asarray([94, 97, 10], jnp.int32))
    chunk = np.random.default_rng(1).uniform(-1, 1, (n, horizon, 4)).astype(np.float32)
    ws, wobs, wr, wd, winfo = jax.vmap(lambda s, a: jw.act_exec_step(jenv, s, a))(
        jstates, jnp.asarray(chunk))
    gs, gobs, gr, gd, ginfo = wrappers.act_exec_step(env, to_torch(jstates),
                                                     torch.from_numpy(chunk))
    np.testing.assert_array_equal(gs.t.numpy(), np.asarray(ws.t))
    np.testing.assert_allclose(gs.physics.mocap_pos.numpy(), np.asarray(ws.physics.mocap_pos),
                               atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for k, v in gobs["state"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(wobs["state"][k]), atol=1e-5, err_msg=k)
    assert gd.tolist() == [0.0, 1.0, 0.0]  # env 1 reaches its limit inside the chunk


def test_torch_action_and_observation_helpers_match_jax():
    rng = np.random.default_rng(2)
    obs = {"state": rng.normal(size=(3, 5)).astype(np.float32),
           "front": rng.integers(0, 256, (3, 4, 4, 3)).astype(np.uint8),
           "wrist": rng.integers(0, 256, (3, 4, 4, 3)).astype(np.uint8)}
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    got = wrappers.front_camera_obs(tobs)
    want = jw.front_camera_obs({k: jnp.asarray(v) for k, v in obs.items()})
    assert set(got) == set(want) == {"state", "front"}
    a6 = rng.uniform(-1, 1, (3, 6)).astype(np.float32)
    np.testing.assert_array_equal(wrappers.gripper_close_action(torch.from_numpy(a6)).numpy(),
                                  np.asarray(jw.gripper_close_action(jnp.asarray(a6))))
    a2 = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    np.testing.assert_array_equal(wrappers.z_only_action(torch.from_numpy(a2)).numpy(),
                                  np.asarray(jw.z_only_action(jnp.asarray(a2))))
    lo, hi = np.float32([-1.0, 0.0, 2.0]), np.float32([1.0, 3.0, 5.0])
    x = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        wrappers.unnormalize_action(torch.from_numpy(x), torch.from_numpy(lo),
                                    torch.from_numpy(hi)).numpy(),
        np.asarray(jw.unnormalize_action(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi))))
    np.testing.assert_array_equal(
        wrappers.normalize_proprio(torch.from_numpy(x), torch.from_numpy(lo),
                                   torch.from_numpy(hi)).numpy(),
        np.asarray(jw.normalize_proprio(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi))))
    mapping = {"proprio": "state", "z": ("state", 2), "image": "front"}
    got = wrappers.remap_obs(tobs, mapping)
    want = jw.remap_obs({k: jnp.asarray(v) for k, v in obs.items()}, mapping)
    for k in mapping:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = (0.0, 1.0, 0.0, 0.0)  # a roll of pi: the flip
    return q


def _angles_close(got_quat, want_quat):
    a = wrappers.quat_to_euler(got_quat).numpy()
    b = np.asarray(jw.quat_to_euler(jnp.asarray(want_quat)))
    diff = np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)
    assert diff.max() <= ANGLE_ATOL, diff.max()


def test_torch_adjoint_and_relative_pose_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    quat = _quats(rng, 5)
    np.testing.assert_allclose(
        wrappers.adjoint_matrix(torch.from_numpy(pos), torch.from_numpy(quat)).numpy(),
        np.asarray(jax.vmap(jw.adjoint_matrix)(jnp.asarray(pos), jnp.asarray(quat))), atol=1e-6)
    ref_pos, ref_quat = rng.normal(size=3).astype(np.float32), _quats(rng, 2)[1]
    for p, q in ((pos, quat), (pos[1], quat[1])):
        gp, gq = wrappers.pose_relative_to(torch.from_numpy(p), torch.from_numpy(q),
                                           torch.from_numpy(ref_pos), torch.from_numpy(ref_quat))
        wp, wq = jw.pose_relative_to(jnp.asarray(p), jnp.asarray(q), jnp.asarray(ref_pos),
                                     jnp.asarray(ref_quat))
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-6)
        np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-6)
        _angles_close(gq.reshape(-1, 4), np.asarray(wq).reshape(-1, 4))


def test_torch_typing_aliases():
    assert ttyping.PRNGKey is torch.Generator
    assert set(ttyping.Batch.__args__) == {str, ttyping.Data}
