"""The port stands alone: no file under serl_tpu_torch/ (nor chip_smoke.py,
nor tests/torch_k1.py, tests/torch_k2.py, tests/torch_k5.py and tests/torch_dp.py, which it loads) imports jax, flax or serl_tpu, it keeps its own copy of the model
constants, and its entry points default to the CUDA device."""

import ast
import importlib
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
                   "examples/external_gym_actor.py", "tools/scaling_analysis.py",
                   "tools/pretrain_resnet10.py", "tools/dump_render_frames.py",
                   "tools/probe_peg.py"):
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


# Public names of serl_tpu/ (module file::name) that the port's module at the
# same path has under another name: the port's counterpart, resolved below.
RENAMED = {
    "distributed/sharding.py::make_mesh": "distributed/sharding.py::init_data_parallel",
    "distributed/sharding.py::replicated": "distributed/sharding.py::replicate_agent",
    "distributed/sharding.py::batch_sharded": "distributed/sharding.py::local",
    "distributed/sharding.py::buffer_sharded": "distributed/sharding.py::shard_carry",
    "distributed/sharding.py::carry_shardings": "distributed/sharding.py::carry_layout",
    "distributed/sharding.py::fwbw_carry_shardings": "distributed/sharding.py::fwbw_carry_layout",
    "distributed/sharding.py::chained_carry_shardings":
        "distributed/sharding.py::chained_carry_layout",
    "envs/rendering.py::render_scene": "envs/rendering.py::render_scene_plain",
    "vision/encoders.py::AddSpatialCoordinates": "vision/encoders.py::add_spatial_coordinates",
    "utils/timer.py::jax_profile": "utils/timer.py::torch_profile",
    "native/build.py::HERE": "native/build.py::PKG",
    "native/build.py::SRC": "native/build.py::TRANSPORT_SOURCE",
    "native/build.py::OUT": "native/build.py::BUILD_DIR",
}
# Public names of serl_tpu/ left out on purpose, each with the reason.
LEFT_OUT = {
    "common/train_state.py::nonpytree_field": "flax's static-field marker: the port's agents "
                                              "are plain torch modules, not pytrees",
    "common/train_state.py::TrainState.create": "the port's TrainState(params=, txs=) is built "
                                                "by its constructor from the agent's tensors",
    "networks/mlp.py::default_init": "flax's initializer factory: the port's layers "
                                     "initialise themselves (variance_scaling_ and kin)",
    "vision/encoders.py::ModuleDef": "a flax type alias",
    "utils/pretrained.py::log": "the JAX loader's logger: the port's loader is strict and "
                                "raises where JAX's warns",
}


def _public_names(path: Path):
    """Top-level functions, classes and their public methods, and module-level
    assignments of `path`, by AST (the JAX module is not imported)."""
    out = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [node.name]
        elif isinstance(node, ast.ClassDef):
            names = [node.name] + [f"{node.name}.{n.name}" for n in node.body
                                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                                   and not n.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names = [node.target.id]
        else:
            names = []
        out += [n for n in names if not n.startswith("_")]
    return out


def _port_has(entry: str) -> bool:
    """Whether the port's module at a JAX module's path ("file::name",
    "file::Class.method") defines or inherits the name."""
    path, name = entry.split("::")
    module = "serl_tpu_torch." + ".".join(Path(path).with_suffix("").parts)
    obj = importlib.import_module(module.removesuffix(".__init__"))
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_torch_port_has_every_jax_public_name():
    """A name-level diff, module by module: every public name of serl_tpu/
    exists in the port's module at the same path (inherited methods count),
    or is in RENAMED (its counterpart must exist) or LEFT_OUT. A new JAX name
    without a counterpart fails, and so does an allowlist entry that the
    port has come to define."""
    names = [f"{p.relative_to(ROOT / 'serl_tpu').as_posix()}::{n}"
             for p in sorted((ROOT / "serl_tpu").rglob("*.py")) for n in _public_names(p)]
    assert len(names) > 400
    missing = {n for n in names if not _port_has(n)}
    assert missing == set(RENAMED) | set(LEFT_OUT), (
        f"no counterpart: {sorted(missing - set(RENAMED) - set(LEFT_OUT))}; allowlisted but "
        f"ported: {sorted((set(RENAMED) | set(LEFT_OUT)) - missing)}")
    unresolved = [f"{k} -> {v}" for k, v in RENAMED.items() if not _port_has(v)]
    assert not unresolved, unresolved


# The repository's tools (tools/*.py: each imports serl_tpu, or writes its
# model file or its test fixtures) that the port does not carry, and why.
TOOLS_LEFT_OUT = {
    "extract_model.py": "needs the reference's MJCF and the mujoco package (absent)",
    "gen_reference_fixtures.py": "needs the reference's code and MJCF (absent)",
    "validate_physics.py": "needs the reference's MJCF and the mujoco package (absent)",
}


def test_torch_port_has_every_tool():
    """Every tools/*.py at the repository root has its port under
    serl_tpu_torch/tools/ or a TOOLS_LEFT_OUT entry, never both."""
    tools = {p.name for p in (ROOT / "tools").glob("*.py")}
    ported = {p.name for p in (ROOT / "serl_tpu_torch" / "tools").glob("*.py")} - {"__init__.py"}
    assert {"pretrain_resnet10.py", "dump_render_frames.py", "probe_peg.py",
            "scaling_analysis.py", "mfu_experiments.py", "perf_speed_of_light.py",
            "perf_pixels.py"} <= ported
    assert tools - ported == set(TOOLS_LEFT_OUT), (
        f"no port and no reason: {sorted(tools - ported - set(TOOLS_LEFT_OUT))}; listed but "
        f"ported or gone: {sorted(set(TOOLS_LEFT_OUT) - (tools - ported))}")
    assert ported <= tools, f"port of no JAX tool: {sorted(ported - tools)}"


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
