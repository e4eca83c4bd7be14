"""The port's `tools/perf_pixels.py` against the JAX package's, on the CPU.

- Each row's `bench_loop` builds `make_drq_sim_experiment` with the JAX
  tool's arguments (both launchers swapped for a recorder): the five rows'
  keyword arguments are equal, the port's device aside.
- The rows' labels are the JAX tool's.
- `main` end to end with `--device cpu` at a tiny size (2 envs, batch 4 x
  UTD 2, 32 px, chunks of one iteration): five rows of finite rates, the
  actor-only row with no grad-steps.
"""

import ast

import numpy as np
import pytest
import torch

import serl_tpu.training.launcher as jax_launcher
import serl_tpu_torch.training.launcher as torch_launcher
from serl_tpu_torch.tools import perf_pixels as tool
from tests.torch_mfu import ROOT, load_jax_tool


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Built(Exception):
    pass


def _recorder(calls):
    def make(**kw):
        calls.append(kw)
        raise _Built
    return make


def test_torch_perf_pixels_builds_the_jax_tools_experiments(monkeypatch):
    jtool = load_jax_tool("perf_pixels")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jax_launcher, "make_drq_sim_experiment", _recorder(jcalls))
    monkeypatch.setattr(torch_launcher, "make_drq_sim_experiment", _recorder(tcalls))
    for _, kw in tool.ROWS:
        kw = dict(kw)
        kw.setdefault("image_size", 128)
        with pytest.raises(_Built):
            jtool.bench_loop(**kw)
        with pytest.raises(_Built):
            tool.bench_loop(device="cpu", **kw)
    assert len(jcalls) == len(tcalls) == 5
    for j, t in zip(jcalls, tcalls):
        assert str(t.pop("device")) == "cpu"
        assert t == j


def test_torch_perf_pixels_rows_are_the_jax_tools():
    source = (ROOT / "tools" / "perf_pixels.py").read_text()
    labels = [n.value for n in ast.walk(ast.parse(source))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)
              and n.value.startswith(("full loop", "actor-only"))]
    assert [label for label, _ in tool.ROWS] == labels


def test_torch_perf_pixels_main_runs_on_cpu(capsys):
    rows = tool.main(["--device", "cpu", "--num_envs", "2", "--batch_size", "4",
                      "--utd_ratio", "2", "--image_size", "32", "--iters", "1"])
    assert [r[0] for r in rows] == [label for label, _ in tool.ROWS]
    for label, steps, grads, ms in rows:
        assert np.isfinite([steps, grads, ms]).all() and steps > 0 and ms > 0
        assert (grads == 0) == label.startswith("actor-only")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 5 and all(line.startswith("| ") and line.endswith(" |") for line in out)


@pytest.mark.parametrize("name", ["mfu_experiments", "perf_speed_of_light", "perf_pixels"])
def test_torch_measurement_tools_default_to_cuda(monkeypatch, name):
    import importlib

    module = importlib.import_module(f"serl_tpu_torch.tools.{name}")
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
