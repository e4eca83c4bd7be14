"""Episode video against serl_tpu's, on the CPU.

- `compose_frames`: exactly JAX's (a copy into a zero canvas), for 2 and 3
  streams of unequal length and 2 and 3 columns.
- `VideoRecorder`: the GIF file byte for byte JAX's (both through PIL), the
  .npz's frames exactly, nothing saved without frames.
- `record_eval_episode`: a state agent (JAX's params carried into the
  port) rolls one argmax episode of the pick env from JAX's own reset
  position, with the episode cut to 5 steps in both packages (the time
  limit patched, so that the loop's early exit is reached) at 16 px. The
  composed frames have JAX's shape and count, and each camera's frames hold
  to JAX's under tests/torch_k2.py's pixel rule (at most 0.5% of pixels
  beyond one uint8 level, each on an edge), as the renderer's own tests hold
  it.
"""

import jax
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.training.launcher import make_sac_agent as jax_make_sac_agent
from serl_tpu.utils import video as jvideo
from serl_tpu_torch.envs import panda_pick
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils import video as tvideo
from serl_tpu_torch.utils.jax_params import load_sac_params
from tests import torch_k2

SIZE = 16
STEPS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(n, seed, h=6, w=5):
    return list(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("lengths,cols", [((4, 3), 2), ((2, 5, 3), 2), ((3, 3, 3), 3)])
def test_torch_compose_frames_matches_jax(lengths, cols):
    streams = [_frames(n, i) for i, n in enumerate(lengths)]
    got, want = tvideo.compose_frames(streams, cols), jvideo.compose_frames(streams, cols)
    assert len(got) == len(want) == min(lengths)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_torch_video_recorder_saves_as_jax(tmp_path):
    frames = _frames(4, 9, 8, 8)
    paths = {}
    for name, module in (("jax", jvideo), ("port", tvideo)):
        rec = module.VideoRecorder(str(tmp_path / name), fps=10)
        assert rec.save("none") is None
        for gif in (True, False):
            for f in frames:
                rec.record(f)
            paths[name, gif] = rec.save("ep", as_gif=gif)
            assert rec.frames == []
    with open(paths["jax", True], "rb") as a, open(paths["port", True], "rb") as b:
        assert paths["port", True].endswith(".gif") and a.read() == b.read()
    got, want = np.load(paths["port", False]), np.load(paths["jax", False])
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(got["frames"], np.stack(frames))


def test_torch_record_eval_episode_matches_jax(monkeypatch):
    monkeypatch.setattr(jpick, "TIME_LIMIT_STEPS", STEPS)
    monkeypatch.setattr(panda_pick, "TIME_LIMIT_STEPS", STEPS)
    jagent = jax_make_sac_agent(0, obs_dim=10, action_dim=4)
    agent = make_sac_agent(1, device="cpu")
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.normal(size=np.shape(x)))
                          .astype(np.float32), jax.device_get(jagent.state.params))
    jagent = jagent.replace(state=jagent.state.replace(params=jax.tree.map(jax.numpy.asarray,
                                                                           params)))
    load_sac_params(agent, params)
    key = jax.random.PRNGKey(3)
    want = jvideo.record_eval_episode(jpick.PandaPickCubeEnv(), jagent, key, render_size=SIZE)
    _, k_block, _ = jax.random.split(key, 3)
    xy = jax.random.uniform(k_block, (2,), minval=jpick.SAMPLING_BOUNDS[0],
                            maxval=jpick.SAMPLING_BOUNDS[1])
    got = tvideo.record_eval_episode(panda_pick.PandaPickCubeEnv(device="cpu"), agent,
                                     reset_xy=torch.from_numpy(np.array(xy))[None],
                                     render_size=SIZE)
    assert len(got) == len(want) == STEPS  # rendered before each step, the last one ends it
    assert got[0].shape == want[0].shape == (SIZE, 2 * SIZE, 3)
    for cam in range(2):  # front | wrist
        g = torch.from_numpy(np.stack([f[:, cam * SIZE:(cam + 1) * SIZE] for f in got]))
        w = torch.from_numpy(np.stack([f[:, cam * SIZE:(cam + 1) * SIZE] for f in want]))
        failures, summary = torch_k2.pixel_rule(g, w)
        assert not failures, (cam, failures, summary)
    assert any(not np.array_equal(got[0], f) for f in got[1:])  # the arm moved
