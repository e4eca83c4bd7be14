"""The port's PandaPickCubeEnv against serl_tpu's, on the CPU.

The JAX env is single-env and vmapped; the port steps all envs at once.
Reset positions are fed to both explicitly (the JAX state is built with
engine.init_state(xy)), actions come from numpy, and the port's state is
handed to JAX before every step so that float32 drift cannot hide a fault.
Observations and rewards are held to 1e-3 (tcp_vel comes from qvel, which
may carry torch_k1.STEP_CAP's 0.1 rad/s times a Jacobian entry below 0.1 m;
the reward is within 1e-3 of exp and lift terms of those observations);
state fields by the per-env rule of torch_k1 with no env excepted (STEP_ATOL
plus 3x the port's own float32-vs-float64 spread, which is large in the
first step from reset, where the pinch sits at the 180-degree target),
except the action's own arithmetic on the mocap target and grip command
(0..255), held to a few float32 ulps: XLA may contract mocap + 0.1 * a into
one fused multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import panda_pick
from serl_tpu_torch.envs.physics import engine
from tests import torch_k1

OBS_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jenv():
    env = jpick.PandaPickCubeEnv()
    return env, jax.jit(jax.vmap(env.step)), jax.jit(jax.vmap(env.step_auto_reset))


def _to_jax(state: panda_pick.EnvState) -> jpick.EnvState:
    n = state.t.shape[0]
    return jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in state.physics)),
        t=jnp.asarray(state.t.numpy()),
        z_init=jnp.asarray(state.z_init.numpy()),
        rng=jax.random.split(jax.random.PRNGKey(0), n),
        ep_id=jnp.asarray(state.ep_id.numpy()),
    )


def _xy(n, seed):
    lo, hi = jpick.SAMPLING_BOUNDS
    return np.random.default_rng(seed).uniform(lo, hi, (n, 2)).astype(np.float32)


def _assert_obs(got, want, atol=OBS_ATOL):
    assert sorted(got["state"]) == sorted(want["state"])
    for k in want["state"]:
        np.testing.assert_allclose(got["state"][k].numpy(), np.asarray(want["state"][k]),
                                   atol=atol, rtol=0, err_msg=k)


ACTION_ATOL = {"mocap_pos": 1e-6, "grip_ctrl": 1e-4}


def _assert_physics(got, want, before, action):
    """`got` and `want` are the port's and JAX's physics after one step of
    `action` from the port's physics `before`."""
    want = engine.PhysicsState(*(torch.from_numpy(np.array(x)) for x in want))
    exact = engine.control_step_plain(
        torch_k1.to_f64(torch_k1.apply_action(before, torch.from_numpy(action))))
    atol = {f: max(a, ACTION_ATOL.get(f, 0.0)) for f, a in torch_k1.STEP_ATOL.items()}
    cap = {f: max(a, ACTION_ATOL.get(f, 0.0)) for f, a in torch_k1.STEP_CAP.items()}
    failures, _ = torch_k1.judge(torch_k1.per_env_errors(got, want),
                                 torch_k1.per_env_errors(got, exact), atol, cap)
    assert not failures, failures


def test_torch_env_reset_and_step_match_jax(jenv):
    _, jstep, _ = jenv
    n = 8
    env = panda_pick.PandaPickCubeEnv(device="cpu")
    xy = _xy(n, 0)
    state, obs = env.reset(n, reset_xy=torch.from_numpy(xy))
    phys = jax.vmap(jengine.init_state)(jnp.asarray(xy))
    want_obs = jax.vmap(jpick.PandaPickCubeEnv()._obs)(_to_jax(state)._replace(physics=phys))
    _assert_obs(obs, want_obs, atol=1e-6)
    rng = np.random.default_rng(1)
    for _ in range(4):
        a = rng.uniform(-1.2, 1.2, (n, 4)).astype(np.float32)  # outside [-1, 1] too
        js, jo, jr, jd, ji = jstep(_to_jax(state), jnp.asarray(a))
        before = state.physics
        state, obs, r, d, info = env.step(state, torch.from_numpy(a))
        _assert_physics(state.physics, js.physics, before, a)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(js.t))
        _assert_obs(obs, jo)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=OBS_ATOL, rtol=0)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(ji["success"]))


def test_torch_grip_ctrl_is_stored_times_255():
    env = panda_pick.PandaPickCubeEnv(device="cpu")
    state, _ = env.reset(2, reset_xy=torch.from_numpy(_xy(2, 2)))
    a = torch.tensor([[0.0, 0.0, 0.0, 0.5], [0.0, 0.0, 0.0, -0.3]])
    state, obs, *_ = env.step(state, a)
    np.testing.assert_allclose(state.physics.grip_ctrl.numpy(), [127.5, 0.0], rtol=1e-6)
    np.testing.assert_allclose(obs["state"]["panda/gripper_pos"].numpy(), [[0.5], [0.0]], rtol=1e-6)


def test_torch_flatten_obs_uses_sorted_key_order():
    rng = np.random.default_rng(3)
    widths = {"panda/tcp_pos": 3, "panda/tcp_vel": 3, "panda/gripper_pos": 1, "block_pos": 3}
    obs_np = {k: rng.normal(size=(5, w)).astype(np.float32) for k, w in widths.items()}
    got = panda_pick.flatten_obs({"state": {k: torch.from_numpy(v) for k, v in obs_np.items()}})
    want = jpick.flatten_obs({"state": {k: jnp.asarray(v) for k, v in obs_np.items()}})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    order = ["block_pos", "panda/gripper_pos", "panda/tcp_pos", "panda/tcp_vel"]
    np.testing.assert_array_equal(got.numpy(), np.concatenate([obs_np[k] for k in order], -1))


def test_torch_step_auto_reset_swaps_every_field_and_counts_episodes(jenv):
    _, _, jauto = jenv
    n = 6
    env = panda_pick.PandaPickCubeEnv(device="cpu")
    state, _ = env.reset(n, reset_xy=torch.from_numpy(_xy(n, 4)))
    # envs 0, 2, 4 are on their last step of the episode
    t = torch.tensor([99, 5, 99, 0, 99, 42], dtype=torch.int32)
    state = state._replace(t=t, ep_id=torch.tensor([3, 1, 0, 2, 7, 5], dtype=torch.int32))
    a = np.random.default_rng(5).uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    reset_xy = _xy(n, 6)
    js, jo, jr, jd, ji = jauto(_to_jax(state), jnp.asarray(a))
    new, obs, r, d, info = env.step_auto_reset(state, torch.from_numpy(a),
                                               reset_xy=torch.from_numpy(reset_xy))
    done = np.asarray(jd) > 0.5
    np.testing.assert_array_equal(done, [True, False, True, False, True, False])
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=OBS_ATOL, rtol=0)
    _assert_obs(info["final_obs"], ji["final_obs"])  # the pre-reset terminal obs
    np.testing.assert_array_equal(new.ep_id.numpy(), np.asarray(js.ep_id))  # +1 on reset
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(js.t))  # 0 on reset
    # ended envs take every field of a fresh env at the given reset position
    fresh = engine.init_state(torch.from_numpy(reset_xy))
    for f in new.physics._fields:
        got, want = getattr(new.physics, f), getattr(fresh, f)
        torch.testing.assert_close(got[done], want[done], rtol=0, atol=0)
    np.testing.assert_allclose(new.z_init.numpy()[done], engine.CUBE_HALF[2])
    fresh_obs = env._obs(new)
    for k in obs["state"]:
        torch.testing.assert_close(obs["state"][k], fresh_obs["state"][k], rtol=0, atol=0)
    # running envs go on as in the JAX env
    keep = ~done
    for k in obs["state"]:
        np.testing.assert_allclose(obs["state"][k].numpy()[keep],
                                   np.asarray(jo["state"][k])[keep], atol=OBS_ATOL, rtol=0)


def test_torch_env_pixels_and_cuda_without_card_raise():
    # pixel observations are ported: the state part without block_pos, and
    # both cameras' uint8 frames (tests/test_torch_render.py holds them to JAX)
    env = panda_pick.PandaPickCubeEnv(image_obs=True, render_size=16, device="cpu")
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    assert sorted(obs["state"]) == ["panda/gripper_pos", "panda/tcp_pos", "panda/tcp_vel"]
    for k in ("front", "wrist"):
        assert obs["images"][k].shape == (2, 16, 16, 3) and obs["images"][k].dtype == torch.uint8
    _, _, _, _, info = env.step_auto_reset(state, torch.zeros(2, 4), final_obs=False)
    assert "final_obs" not in info
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            panda_pick.PandaPickCubeEnv()  # the default device is CUDA
