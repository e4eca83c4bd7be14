"""The port's render dump against the JAX package's
`tools/dump_render_frames.py`, on the CPU: the JAX tool's own `main` (loaded
from its file, run with PIL hidden so that it writes frames.npz) and the
port's `main`, whose cube starts at `RESET_XY`, equal to the JAX tool's
reset draw from PRNGKey(3) bit for bit. The summary values (final reward,
success, highest cube z) within the printed rounding (0.0005) plus
SUMMARY_ATOL; the front and wrist frames at every SNAP_TS under
tests/torch_k2.py's pixel rule; with PIL, the PNG names (step, reward, cube
z) equal to the JAX tool's committed `results/render_frames`.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import pytest
import numpy as np
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu_torch.tools import dump_render_frames as dump
from tests.torch_k2 import pixel_rule

ROOT = Path(__file__).resolve().parents[1]
SUMMARY_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load_jax_tool(name: str):
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:  # the tool's import sets JAX's compilation cache directory
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def _summary_values(line: str):
    fields = dict(kv.split("=") for kv in line.split()[2:])
    return float(fields["reward"]), float(fields["success"]), float(fields["max_cube_z"])


def test_torch_dump_render_frames_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    jtool = _load_jax_tool("dump_render_frames")
    assert dump.SNAP_TS == jtool.SNAP_TS
    state, _ = jpick.PandaPickCubeEnv(image_obs=True).reset(jax.random.PRNGKey(3))
    np.testing.assert_array_equal(np.asarray(state.physics.cube_pos[:2]),
                                  np.asarray(dump.RESET_XY, np.float32))
    monkeypatch.setitem(sys.modules, "PIL", None)  # both tools write frames.npz
    monkeypatch.setattr(sys, "argv", ["dump_render_frames.py", str(tmp_path / "jax")])
    jtool.main()
    outs = dump.main([str(tmp_path / "port"), "--device", "cpu"])
    jax_lines, port_lines = capsys.readouterr().out.splitlines()[::2]
    want, got = _summary_values(jax_lines), _summary_values(port_lines)
    assert got == _summary_values(dump.summary(outs))
    assert got[1] == want[1]
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert abs(g - w) <= 0.0005 + SUMMARY_ATOL, (got, want)
    jframes = np.load(tmp_path / "jax" / "frames.npz")
    pframes = np.load(tmp_path / "port" / "frames.npz")
    assert sorted(jframes.files) == sorted(pframes.files) == sorted(f"t{t}" for t in
                                                                     dump.SNAP_TS)
    for key in jframes.files:
        failures, summary = pixel_rule(torch.from_numpy(pframes[key]),
                                       torch.from_numpy(jframes[key]))
        assert not failures, (key, failures, summary)
    monkeypatch.delitem(sys.modules, "PIL")
    dump.save_frames(outs, str(tmp_path / "png"))
    names = sorted(p.name for p in (tmp_path / "png").iterdir())
    assert names == sorted(p.name for p in (ROOT / "results" / "render_frames").iterdir())
