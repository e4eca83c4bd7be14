"""K2, the renderer, against serl_tpu's on the CPU.

The port's plain `render_cameras` and serl_tpu's vmapped `render_cameras`
render the same physics states: envs of a JAX rollout under random actions
(arm moved, cube pushed) and the constructed grasp states of
tests/torch_k1.py (pads and cube in the wrist camera's view), at 32 px and,
for two envs, at 128 px. The frames are held to each other by the pixel rule
of tests/torch_k2.py: at most 0.5% of the pixels may differ by more than one
uint8 level in a channel, and each of those must lie on an edge of the JAX
frame, since a float32 hit test can flip there (torch_k2.py derives the
share). The kernel's own code (csrc/render.cuh, built for the CPU by g++
without contracted multiply-adds): its per-camera and per-pixel stages must
equal the plain version exactly from the plain version's scene rows, since
both round at the same places; its scene stage must give the rows of the
plain version and of the JAX package within torch_k2.SCENE_ATOL; its
checker parity must equal fmod's; and faults planted in a copy of it must
show.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import rendering as jrender
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.envs.physics.arm import fk as jfk
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
    # the operation count of K2's bound: the code's own, per pixel and per
    # (env, camera); and the unhoisted count (every camera invariant once per
    # pixel, fmod for the parity), 1,287 per pixel on these states, where
    # every ray points down
    ops = torch_k2.render_ops(states, 16)
    n, pixels = states.qpos.shape[0], 16 * 16
    assert 900 < ops["pixel"] / (n * 2 * pixels) < 1050, ops
    assert 250 < ops["camera"] / (n * 2) < 400, ops
    assert ops["unhoisted"] == 1287 * n * 2 * pixels, ops


def _jax_scene_rows(states):
    """(N, SCENE_FLOATS) rows of serl_tpu's build_scene plus the camera
    poses of its render_cameras, in pack_scene's layout."""
    js = jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in states))

    def one(st):
        sc = jrender.build_scene(st)
        kin = jfk(st.qpos)
        att_R = kin.R[7] @ jrender._ATT_R_L7
        att_p = kin.p[7] + kin.R[7] @ jrender._ATT_POS_L7
        wrist = jnp.concatenate([att_p + att_R @ jrender._WRIST_POS_ATT,
                                 (att_R @ jrender._WRIST_R_ATT).reshape(9)])
        front = jnp.concatenate([jnp.asarray(jrender._FRONT_POS),
                                 jnp.asarray(jrender._FRONT_R).reshape(9)])
        sph = jnp.concatenate([sc.sph_c, sc.sph_r[:, None], sc.sph_col], 1)
        cap = jnp.concatenate([sc.cap_a, sc.cap_b, sc.cap_r[:, None], sc.cap_col], 1)
        box = jnp.concatenate([sc.box_c, sc.box_R.reshape(-1, 9), sc.box_h, sc.box_col], 1)
        return jnp.concatenate([front, wrist, sph.reshape(-1), cap.reshape(-1), box.reshape(-1)])

    return torch.from_numpy(np.array(jax.jit(jax.vmap(one))(js)))


def test_torch_render_kernel_scene_matches_plain_and_jax(states):
    got = torch_k2.host_scene(states)
    for want in (rendering.pack_scene(states), _jax_scene_rows(states)):
        assert want.shape == got.shape == (6, rendering.SCENE_FLOATS)
        torch.testing.assert_close(got, want, rtol=0, atol=torch_k2.SCENE_ATOL)
    # the state moves the scene: the arm, the pads and the cube differ by env
    assert float((got - got[:1]).abs().amax()) > 0.05


def test_torch_render_kernel_parity_equals_fmod():
    assert torch_k2.parity_mismatches() == 0


# Faults planted in a copy of render.cuh: (what, text, replacement, stage)
K2_FAULTS = [
    ("hoisted capsule s at the wrong axis", "o[0] - (a[0] + s * abx)", "o[0] - (a[0] + s * aby)",
     "pixels"),
    ("box slab bounds swapped", "v[j] = -h[j] - ol;", "v[j] = h[j] - ol;", "pixels"),
    ("checker parity inverted", "return k - 2.0f * floorf(0.5f * k) == 0.0f;",
     "return k - 2.0f * floorf(0.5f * k) != 0.0f;", "pixels"),
    ("joint rotation the other way", "r[1] = f[0] * -s + f[1] * c;", "r[1] = f[0] * s + f[1] * c;",
     "scene"),
    ("wrist camera without its offset", "row[CAM_FLOATS + i] = att_p + row_dot(att, C + C_WRIST_POS);",
     "row[CAM_FLOATS + i] = att_p;", "scene"),
]


@pytest.mark.parametrize("what,text,replacement,stage", K2_FAULTS, ids=[f[0] for f in K2_FAULTS])
def test_torch_render_kernel_code_planted_fault_fails(states, tmp_path, what, text, replacement,
                                                      stage):
    source = (Path(torch_k2.CSRC) / "render.cuh").read_text()
    assert source.count(text) == 1, what
    (tmp_path / "render.cuh").write_text(source.replace(text, replacement))
    if stage == "scene":
        err = (torch_k2.host_scene(states, csrc=str(tmp_path)) - rendering.pack_scene(states)).abs()
        assert float(err.max()) > torch_k2.SCENE_ATOL, what
    else:
        got = torch_k2.host_render(states, 32, csrc=str(tmp_path))
        want = rendering.render_cameras_plain(states, 32)
        assert any(torch_k2.pixel_rule(g, w)[0] for g, w in zip(got, want)), what


def test_torch_render_scene_layout_matches_header(states):
    """pack_scene's row is what render.cuh reads, and kernel_constants' row
    what it reads the constants from: sizes, offsets and a few fields."""
    header = (Path(torch_k2.CSRC) / "render.cuh").read_text()
    for name in ("CAM_FLOATS", "SPH_FLOATS", "CAP_FLOATS", "BOX_FLOATS", "N_SPH", "N_CAP",
                 "N_BOX"):
        assert int(re.search(rf"{name} = (\d+)", header).group(1)) == getattr(rendering, name)
    assert int(re.search(r"K_COUNT = (\d+)", header).group(1)) == rendering.RENDER_CONSTANTS.size
    # C_<NAME> = C_<PREVIOUS> + <size of PREVIOUS>, in the table's order
    offsets = {"C_BODY_POS": 0}
    for name, prev, size in re.findall(r"(C_\w+) = (C_\w+) \+ (\w+),", header):
        offsets[name] = offsets[prev] + (int(size) if size.isdigit() else
                                         int(re.search(rf"{size} = (\d+)", header).group(1)))
    at = 0
    for name, array in rendering._kernel_constant_table():
        assert offsets[f"C_{name}"] == at, name
        at += np.asarray(array).size
    assert offsets["C_COUNT"] == at == rendering.kernel_constants().size
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
    rows = torch.empty((16, rendering.SCENE_FLOATS), device="cuda")
    got = rendering.render_cameras(s, 128)
    rendering.render_cameras_cuda(s, 128, scene_out=rows)
    assert rendering.render_cameras.launches == before + 4  # two kernels a render
    torch.testing.assert_close(rows, rendering.pack_scene(s), rtol=0, atol=torch_k2.SCENE_ATOL)
    want = rendering.render_cameras_plain(s, 128)
    for gf, wf in zip(got, want):
        failures, summary = torch_k2.pixel_rule(gf.cpu(), wf.cpu())
        assert not failures, (failures, summary)
