"""The gym adapter and the external actor against serl_tpu's, on the CPU.

- `FrankaTaskGymEnv` and `PandaPickCubeGymEnv` (gymnasium 1.x, installed
  here) beside the JAX package's classes: equal observation and action
  spaces; a reset from JAX's draws (its key for the seed), then the JAX
  env's state grafted into the port and 4 steps of the same actions in
  both: observations to 1e-4 (the tcp pose's Euler angles modulo 2 pi to
  1e-3: the peg task's roll sits at the +-pi flip), force and torque zero,
  rewards to 1e-5, terminated exactly, never truncated; the pick env's
  render under tests/torch_k2.py's pixel rule; the gymnasium-free bases do
  the same work. `register_envs` registers the JAX package's ids (max 100
  steps) for this module's classes (the registry restored afterwards).
- `examples/external_gym_actor.py` as two CPU processes, as
  tests/test_external_actor.py runs JAX's: the learner (batch 32 x UTD 2,
  training from 64 rows) and the gym actor (200 steps, 100 random), which
  pushes its transitions and loads the learner's published params.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from serl_tpu.envs import gym_adapter as jgym  # noqa: E402
from serl_tpu_torch.envs import gym_adapter  # noqa: E402
from serl_tpu_torch.examples import external_gym_actor  # noqa: E402
from tests import torch_k2  # noqa: E402
from tests._ports import next_port_pair  # noqa: E402
from tests.torch_pose_jax import angle_error, jax_reset_draws, to_torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _actions(n, dim, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, dim)).astype(np.float32)


def test_torch_franka_gym_env_matches_jax_step_by_step():
    jenv = jgym.FrankaTaskGymEnv()
    env = gym_adapter.FrankaTaskGymEnv(device="cpu")
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    _, key = jax.random.split(jax.random.PRNGKey(0))  # what reset(seed=0) draws from
    jobs, _ = jenv.reset(seed=0)
    obs, info = env.reset(seed=0, draws=jax_reset_draws(key[None], env._env.config))
    assert info == {} and set(obs["state"]) == set(jobs["state"])
    np.testing.assert_allclose(obs["state"]["tcp_pose"][:3], jobs["state"]["tcp_pose"][:3],
                               atol=1e-4)
    # from here on the JAX state itself, grafted
    env._state = to_torch(jax.tree.map(lambda x: x[None], jenv._state))
    for a in _actions(4, 7):
        jo, jr, jt, jtr, ji = jenv.step(a)
        o, r, t, tr, i = env.step(a)
        for k in ("tcp_vel", "gripper_pose"):
            np.testing.assert_allclose(o["state"][k], jo["state"][k], atol=1e-4, err_msg=k)
        np.testing.assert_allclose(o["state"]["tcp_pose"][:3], jo["state"]["tcp_pose"][:3],
                                   atol=1e-4)
        assert angle_error(o["state"]["tcp_pose"][3:], jo["state"]["tcp_pose"][3:]).max() <= 1e-3
        for k in ("tcp_force", "tcp_torque"):
            assert o["state"][k].dtype == np.float32 and not o["state"][k].any()
        assert abs(r - jr) <= 1e-5 and t == jt and tr is False and isinstance(r, float)
        assert set(i) == set(ji)


def test_torch_pick_gym_env_and_its_render_match_jax():
    jenv = jgym.PandaPickCubeGymEnv(image_obs=True, render_size=32)
    env = gym_adapter.PandaPickCubeGymEnv(image_obs=True, render_size=32, device="cpu")
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    jenv.reset(seed=3)
    env.reset(seed=3)
    env._state = to_torch(jax.tree.map(lambda x: x[None], jenv._state))
    for a in _actions(3, 4, 1):
        jo, jr, jt, _, _ = jenv.step(a)
        o, r, t, _, _ = env.step(a)
        for k, v in jo["state"].items():
            np.testing.assert_allclose(o["state"][k], v, atol=1e-4, err_msg=k)
        assert abs(r - jr) <= 1e-5 and t == jt
    want = jenv.render()
    got = env.render()
    ids = torch_k2.surface_ids(env._state.physics, 32)
    for g, w, i in zip(got, want, ids):
        assert g.shape == (32, 32, 3) and g.dtype == np.uint8
        failures, _ = torch_k2.pixel_rule(torch.from_numpy(g)[None], torch.from_numpy(np.array(w))[None],
                                          i)
        assert not failures, failures
    # the gymnasium-free base does the same work
    base = gym_adapter.PandaPickCubeGymBase(image_obs=True, render_size=32, device="cpu")
    bo, _ = base.reset(seed=3)
    eo, _ = gym_adapter.PandaPickCubeGymEnv(image_obs=True, render_size=32,
                                            device="cpu").reset(seed=3)
    for k in ("front", "wrist"):
        np.testing.assert_array_equal(bo["images"][k], eo["images"][k])


def test_torch_register_envs_takes_the_jax_ids():
    registry = gym.envs.registry
    saved = {k: registry.get(k) for k in gym_adapter.ENV_IDS}
    try:
        gym_adapter.register_envs(device="cpu")
        for env_id, (cls, kwargs) in gym_adapter.ENV_IDS.items():
            spec = registry[env_id]
            assert spec.entry_point == f"serl_tpu_torch.envs.gym_adapter:{cls}"
            assert spec.max_episode_steps == 100 and spec.kwargs == {**kwargs, "device": "cpu"}
        env = gym.make("FrankaPegInsert-v0")
        assert isinstance(env.unwrapped, gym_adapter.FrankaTaskGymEnv)
        assert env.unwrapped.device == torch.device("cpu")
        assert set(jgym.PandaPickCubeGymEnv.__mro__) & {gym.Env}
    finally:
        for k, spec in saved.items():
            if spec is None:
                registry.pop(k, None)
            else:
                registry[k] = spec


def test_torch_franka_gym_base_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gym_adapter.FrankaTaskGymBase()


def test_torch_serl_obs_flatten_is_the_reference_wrapper():
    obs = {"state": {"tcp_vel": np.ones(3), "gripper_pose": np.zeros(1),
                     "tcp_pose": np.arange(6.0), "tcp_force": np.zeros(3),
                     "tcp_torque": np.full(3, 2.0)}, "images": {"front": np.zeros((2, 2, 3))}}
    flat = external_gym_actor.serl_obs_flatten(obs)
    assert flat["state"].shape == (external_gym_actor.OBS_DIM,)
    np.testing.assert_array_equal(flat["state"][1:4], 0.0)  # gripper (1), then the force (3)
    assert "front" in flat


def test_torch_external_actor_and_learner_run_as_two_processes():
    port = next_port_pair()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    common = [sys.executable, "-m", "serl_tpu_torch.examples.external_gym_actor", "--device",
              "cpu", "--port", str(port), "--batch_size", "32", "--critic_actor_ratio", "2",
              "--training_starts", "64", "--steps_per_publish", "2"]
    learner = subprocess.Popen(common + ["--learner", "--max_steps", "8"],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               env=env, cwd=REPO)
    actor = subprocess.Popen(common + ["--actor", "--max_steps", "200", "--random_steps", "100",
                                       "--steps_per_update", "10"],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=REPO)
    try:
        learner_out, _ = learner.communicate(timeout=240)
        actor_out, _ = actor.communicate(timeout=240)
    finally:
        for p in (learner, actor):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert learner.returncode == 0, learner_out[-4000:]
    assert actor.returncode == 0, actor_out[-4000:]
    assert "learner done" in learner_out and "actor done: 2 episodes" in actor_out
    import json

    summary = json.loads(next(ln for ln in actor_out.splitlines()
                              if ln.startswith("actor summary "))[len("actor summary "):])
    assert summary["versions_loaded"] >= 1
    lsum = json.loads(next(ln for ln in learner_out.splitlines()
                           if ln.startswith("learner summary "))[len("learner summary "):])
    assert lsum["ring_at_start"] >= 64 and lsum["critic_loss_finite"]
