"""K2, the renderer, against serl_tpu's on the CPU.

The port's plain `render_cameras` and serl_tpu's vmapped `render_cameras`
render the same physics states: envs of a JAX rollout under random actions
(arm moved, cube pushed) and the constructed grasp states of
tests/torch_k1.py (pads and cube in the wrist camera's view), at 32 px and,
for two envs, at 128 px. The frames are held to each other by the pixel rule
of tests/torch_k2.py: at most 0.5% of the pixels may differ by more than one
uint8 level in a channel, and each of those must lie on an edge of the JAX
frame, since a float32 hit test can flip there (torch_k2.py derives the
share). The kernel's own per-pixel code (csrc/render.cuh, built for the CPU
by g++ without contracted multiply-adds, as render.cu is built with
-fmad=false) must equal the plain version exactly: both round at the same
places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import rendering as jrender
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import panda_pick, rendering
from serl_tpu_torch.envs.physics import engine
from tests import torch_k1, torch_k2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_rollout(n, steps, seed):
    env = jpick.PandaPickCubeEnv()
    states, _ = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(seed), n))
    step = jax.jit(jax.vmap(env._step_state))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = jnp.asarray(rng.uniform(-1, 1, (n, 4)).astype(np.float32))
        states = step(states, a)[0]
    return engine.PhysicsState(*(torch.from_numpy(np.array(x)) for x in states.physics))


@pytest.fixture(scope="module")
def states():
    g = torch.Generator().manual_seed(3)
    parts = [_jax_rollout(4, 25, 0), torch_k1.grasp_states(2, g, "cpu")]
    return engine.PhysicsState(*(torch.cat(x) for x in zip(*parts)))


def _jax_frames(s, size):
    js = jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in s))
    front, wrist = jax.jit(jax.vmap(lambda st: jrender.render_cameras(st, size)))(js)
    return torch.from_numpy(np.array(front)), torch.from_numpy(np.array(wrist))


@pytest.mark.parametrize("size,envs", [(32, slice(None)), (128, slice(3, 5))])
def test_torch_render_matches_jax(states, size, envs):
    s = engine.PhysicsState(*(x[envs] for x in states))
    got = rendering.render_cameras(s, size)
    want = _jax_frames(s, size)
    for cam, g, w in zip(("front", "wrist"), got, want):
        failures, summary = torch_k2.pixel_rule(g, w)
        assert not failures, (cam, failures, summary)
        # the frames show the scene: sky, floor and the shaded arm give the
        # front camera many distinct colours; the wrist camera sees mostly
        # flat box faces (pads, hand, cube) and the floor
        assert len(torch.unique(w.reshape(-1, 3), dim=0)) > {"front": 50, "wrist": 8}[cam], cam


def test_torch_render_kernel_code_equals_plain(states):
    for size in (32, 48):
        got = torch_k2.host_render(states, size)
        want = rendering.render_cameras_plain(states, size)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # the operation count of K2's bound: the code's own, per pixel
    per_pixel = torch_k2.render_ops(states, 16) / (states.qpos.shape[0] * 2 * 16 * 16)
    assert 1200 < per_pixel < 1400, per_pixel


def test_torch_render_scene_layout_matches_header(states):
    """pack_scene's row is what render.cuh reads: sizes and a few fields."""
    import re
    from pathlib import Path

    header = (Path(__file__).parents[1] / "serl_tpu_torch" / "csrc" / "render.cuh").read_text()
    for name in ("CAM_FLOATS", "SPH_FLOATS", "CAP_FLOATS", "BOX_FLOATS", "N_SPH", "N_CAP",
                 "N_BOX"):
        assert int(re.search(rf"{name} = (\d+)", header).group(1)) == getattr(rendering, name)
    assert int(re.search(r"K_COUNT = (\d+)", header).group(1)) == rendering.RENDER_CONSTANTS.size
    row = rendering.pack_scene(states)
    scene = rendering.build_scene(states)
    pos, rot = rendering.camera_poses(states)
    assert row.shape == (states.qpos.shape[0], rendering.SCENE_FLOATS) == (6, 170)
    torch.testing.assert_close(row[:, 12:15], pos[:, 1], rtol=0, atol=0)
    torch.testing.assert_close(row[:, 15:24], rot[:, 1].reshape(-1, 9), rtol=0, atol=0)
    box0 = 24 + 2 * 7 + 6 * 10
    torch.testing.assert_close(row[:, box0:box0 + 3], scene.box_c[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(row[:, box0 + 3:box0 + 12], scene.box_R[:, 0].reshape(-1, 9),
                               rtol=0, atol=0)


def test_torch_pixel_env_obs_matches_jax(states):
    env = panda_pick.PandaPickCubeEnv(image_obs=True, render_size=32, device="cpu")
    jenv = jpick.PandaPickCubeEnv(image_obs=True, render_size=32)
    n = states.qpos.shape[0]
    st = panda_pick.EnvState(physics=states, t=torch.zeros(n, dtype=torch.int32),
                             z_init=states.cube_pos[:, 2].clone(),
                             ep_id=torch.zeros(n, dtype=torch.int32))
    jst = jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in states)),
        t=jnp.zeros(n, jnp.int32), z_init=jnp.asarray(states.cube_pos[:, 2].numpy()),
        rng=jax.random.split(jax.random.PRNGKey(0), n), ep_id=jnp.zeros(n, jnp.int32))
    obs = env._obs(st)
    jobs = jax.jit(jax.vmap(jenv._obs))(jst)
    assert sorted(obs["state"]) == sorted(jobs["state"])  # no block_pos with images
    for k, v in jobs["state"].items():
        np.testing.assert_allclose(obs["state"][k].numpy(), np.asarray(v), atol=1e-5, rtol=0)
    for k in ("front", "wrist"):
        failures, summary = torch_k2.pixel_rule(obs["images"][k],
                                                torch.from_numpy(np.array(jobs["images"][k])))
        assert not failures, (k, failures, summary)


@pytest.mark.cuda
def test_torch_render_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    s = torch_k1.grasp_states(16, g, "cuda")
    before = rendering.render_cameras.launches
    got = rendering.render_cameras(s, 128)
    assert rendering.render_cameras.launches == before + 1
    want = rendering.render_cameras_plain(s, 128)
    for gf, wf in zip(got, want):
        failures, summary = torch_k2.pixel_rule(gf.cpu(), wf.cpu())
        assert not failures, (failures, summary)
