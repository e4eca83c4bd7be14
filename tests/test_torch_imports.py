"""The port stands alone: no file under serl_tpu_torch/ (nor chip_smoke.py,
nor tests/torch_k1.py, tests/torch_k2.py, tests/torch_k5.py and tests/torch_dp.py, which it loads) imports jax, flax or serl_tpu, it keeps its own copy of the model
constants, and its entry points default to the CUDA device."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import serl_tpu_torch
from serl_tpu.envs.physics import panda_model as jax_pm
from serl_tpu_torch.envs.physics import panda_model as pm

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "serl_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_torch_port_never_imports_jax_or_serl_tpu():
    files = sorted((ROOT / "serl_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_k1.py", ROOT / "tests" / "torch_k2.py",
        ROOT / "tests" / "torch_k5.py", ROOT / "tests" / "torch_dp.py"]
    assert len(files) > 15
    scanned = {str(path.relative_to(ROOT)) for path in files}
    for module in ("data/demos.py", "envs/scripted_expert.py", "training/runner.py",
                   "training/config.py", "common/logger.py", "utils/timer.py",
                   "examples/fused_sac_state_sim.py", "examples/learning_check.py",
                   "networks/classifier.py", "agents/vice.py", "agents/bc.py",
                   "data/dataset.py", "common/evaluation.py", "examples/fused_cable_route.py",
                   "examples/vice_online.py", "examples/train_reward_classifier.py",
                   "examples/record_demo.py", "examples/bc_policy.py",
                   "envs/chained_bin.py", "data/routed_buffer.py", "training/fwbw.py",
                   "examples/fused_fwbw_bin_relocation.py", "distributed/serialization.py",
                   "distributed/transport.py", "data/host_buffer.py",
                   "examples/async_sac_state_sim.py", "examples/async_drq_sim.py",
                   "distributed/sharding.py", "examples/dryrun_multichip.py",
                   "envs/goal_conditioned.py", "vision/mobilenet.py", "vision/mobilenet_v1.py",
                   "utils/video.py", "common/typing.py", "data/rlds.py",
                   "data/trajectory_log.py", "envs/gym_adapter.py",
                   "examples/external_gym_actor.py", "tools/scaling_analysis.py"):
        assert f"serl_tpu_torch/{module}" in scanned, module
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_torch_port_model_constants_equal_serl_tpu():
    names = [n for n in dir(jax_pm) if n.isupper()]
    assert len(names) > 30
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(pm, name)),
                                      np.asarray(getattr(jax_pm, name)), err_msg=name)


def test_torch_entry_points_default_to_cuda():
    assert serl_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert serl_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            serl_tpu_torch.resolve_device()
        from serl_tpu_torch.training.launcher import make_state_sim_experiment

        with pytest.raises(RuntimeError, match="CUDA"):
            make_state_sim_experiment()


def test_torch_port_has_every_jax_module():
    """A module-tree diff: every module of serl_tpu/ has its counterpart at
    the same path under serl_tpu_torch/ (the JAX package's examples and
    tools live outside it; their ports are under serl_tpu_torch/examples and
    serl_tpu_torch/tools)."""
    jax_modules = {p.relative_to(ROOT / "serl_tpu") for p in (ROOT / "serl_tpu").rglob("*.py")}
    port = ROOT / "serl_tpu_torch"
    missing = sorted(str(m) for m in jax_modules if not (port / m).exists())
    assert not missing, missing
    for script in ("external_gym_actor.py", "async_sac_state_sim.py", "fused_drq_sim.py"):
        assert (ROOT / "examples" / script).exists() and (port / "examples" / script).exists()
    assert (port / "tools" / "scaling_analysis.py").exists()


def test_torch_new_entry_points_default_to_cuda(monkeypatch):
    from serl_tpu_torch.data.dataset import Dataset
    from serl_tpu_torch.envs import gym_adapter
    from serl_tpu_torch.examples import external_gym_actor

    assert external_gym_actor.parser().parse_args(["--actor"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (gym_adapter.PandaPickCubeGymBase, gym_adapter.FrankaTaskGymBase,
                 lambda: Dataset({"rewards": np.zeros(3)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
