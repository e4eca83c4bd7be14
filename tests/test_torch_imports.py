"""The port stands alone: no file under serl_tpu_torch/ (nor chip_smoke.py,
nor tests/torch_k1.py, tests/torch_k2.py and tests/torch_k5.py, which it loads) imports jax, flax or serl_tpu, it keeps its own copy of the model
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
        ROOT / "tests" / "torch_k5.py"]
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
                   "examples/fused_fwbw_bin_relocation.py"):
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
