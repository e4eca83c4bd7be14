"""The port's two-process mode against serl_tpu's, on the CPU.

  * Publish: the tree the port's learner publishes (`to_jax_layout`) against
    JAX's `agent.state.params`, for the state and the pixel agent, with
    JAX's params grafted into the port: same paths, shapes and dtypes,
    values exactly equal.
  * Actor: the port actor's transitions at N = 1 (`transition`) against
    JAX's unbatched `env.step` from the same state and action, across an
    episode end: obs, next_obs and reward within 1e-3 (tests/test_torch_slice.py's
    tolerance), mask and done exactly; the pixel transition's layout equal
    to JAX's `_example_transition`.
  * RLPD mix: `_sample_rlpd` against JAX's on equal rings and seeds, exactly.
  * Learner: one update (the second) from a batch of the port's host ring
    (`get_iterator` on the CPU) against JAX's `update_high_utd` on the batch
    JAX's host ring samples with the same seed (equal, exactly) and the same
    draws, at tests/test_torch_learner.py's tolerances.
  * Two processes: `async_sac_state_sim.py` and `async_drq_sim.py`
    (32 px, a demo file written by the port's `save_demos`), each as a
    learner and an actor subprocess with `--device cpu` on a port pair of
    tests/torch_ports.py (a learner that fails to bind is relaunched on the
    next pair, up to 3 times). Both pairs start before this file's first
    test and run beside it; every process has its own timeout. The
    transitions reach the learner, its critic losses are finite, the actor
    loads at least one published version and every digest it prints is one
    the learner printed for a version it published, and all four exit 0.
"""

import importlib.util
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data.host_buffer import ReplayBufferDataStore as JaxStore
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.training.launcher import make_drq_agent as jax_make_drq_agent
from serl_tpu.training.launcher import make_sac_agent as jax_make_sac_agent
from serl_tpu_torch.data.demos import save_demos
from serl_tpu_torch.data.host_buffer import ReplayBufferDataStore, map_tree
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv, flatten_obs
from serl_tpu_torch.examples import async_drq_sim, async_sac_state_sim
from serl_tpu_torch.training.config import WorkloadConfig
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils.jax_params import load_sac_params, to_jax_layout, train_state_to_jax_layout
from tests.test_torch_learner import (
    OPT,
    assert_states_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.torch_ports import next_port_pair

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-3
SIZE = 32  # the pixel runs' image size
PROCESS_TIMEOUT = 150


def _jax_example(name: str):
    """examples/<name>.py of the JAX package, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------- two processes
# started first (autouse, module scope): they run beside the tests below


def _demo_file(path: Path, n: int = 40) -> str:
    """Stacked transitions in the pixel example's layout, saved by the
    port's save_demos (tensors in, numpy arrays in the pickle)."""
    rng = np.random.default_rng(0)

    def obs():
        return {"state": torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)),
                **{k: torch.from_numpy(rng.integers(0, 256, (n, 1, SIZE, SIZE, 3), dtype=np.uint8))
                   for k in ("front", "wrist")}}
    save_demos({"observations": obs(), "next_observations": obs(),
                "actions": torch.rand(n, 4) * 2 - 1, "rewards": torch.rand(n),
                "masks": torch.ones(n), "dones": torch.zeros(n), "success": torch.zeros(n),
                "ep_ids": torch.zeros(n, dtype=torch.int32)}, str(path))
    return str(path)


RUNS = {
    "state": ("serl_tpu_torch.examples.async_sac_state_sim",
              ["--batch_size", "32", "--critic_actor_ratio", "2", "--training_starts", "48"],
              ["--max_steps", "8", "--log_period", "2"],
              ["--max_steps", "120", "--random_steps", "60", "--steps_per_update", "8"]),
    "pixels": ("serl_tpu_torch.examples.async_drq_sim",
               ["--image_size", str(SIZE), "--batch_size", "16", "--critic_actor_ratio", "2",
                "--training_starts", "48"],
               ["--max_steps", "4", "--log_period", "1", "--publish_period", "2"],
               ["--max_steps", "110", "--random_steps", "60", "--steps_per_update", "8"]),
}


def _start(module, args, log: Path):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-m", module, "--device", "cpu", "--diagnostics",
                             *args], stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env,
                            cwd=REPO)


def _start_learner(module, args, log: Path):
    """(learner process, port): relaunched on the next pair, up to 3 times,
    if it fails to bind."""
    for _ in range(3):
        port = next_port_pair()
        proc = _start(module, ["--learner", "--port", str(port), *args], log)
        deadline = time.time() + 90
        while time.time() < deadline:
            text = log.read_text()
            if "waiting for data" in text:
                return proc, port
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        if proc.poll() is None or "could not bind" not in log.read_text():
            proc.kill()
            proc.wait()
            raise AssertionError(f"the learner did not start:\n{log.read_text()[-3000:]}")
    raise AssertionError("the learner failed to bind 3 port pairs")


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("async")
    procs, out = [], {}
    demo = _demo_file(tmp / "demos.pkl")
    try:
        for name, (module, common, learner_args, actor_args) in RUNS.items():
            if name == "pixels":
                learner_args = learner_args + ["--demo_path", demo]
            logs = {"learner": tmp / f"{name}_learner.log", "actor": tmp / f"{name}_actor.log"}
            learner, port = _start_learner(module, common + learner_args, logs["learner"])
            actor = _start(module, ["--actor", "--port", str(port), *common, *actor_args],
                           logs["actor"])
            procs += [learner, actor]
            out[name] = {"procs": {"learner": learner, "actor": actor}, "logs": logs,
                         "started": time.time()}
        yield out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _finish(run) -> dict:
    """Each process waited for within its own timeout (killed on expiry):
    {role: (return code, output)}."""
    result = {}
    for role, proc in run["procs"].items():
        try:
            proc.wait(timeout=max(1.0, run["started"] + PROCESS_TIMEOUT - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        result[role] = (proc.returncode, run["logs"][role].read_text())
    return result


def _summary(text: str, who: str) -> dict:
    import json

    line = next(ln for ln in text.splitlines() if ln.startswith(f"{who} summary "))
    return json.loads(line[len(f"{who} summary "):])


# ---------------------------------------------------------------- publish


def _paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_published_equals(published, jax_params):
    got, want = _paths(published), _paths(jax_params)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_torch_published_state_tree_equals_jax_params():
    jax_params = jax.tree.map(np.asarray, jax_make_sac_agent(0).state.params)
    agent = make_sac_agent(1, device="cpu")
    load_sac_params(agent, jax_params)
    _assert_published_equals(to_jax_layout(agent), jax_params)


def test_torch_published_pixel_tree_equals_jax_params():
    img = jnp.zeros((1, 1, SIZE, SIZE, 3), jnp.uint8)
    jagent = jax_make_drq_agent(0, {"state": jnp.zeros((1, 7)), "front": img, "wrist": img},
                                jnp.zeros((1, 4)), image_keys=("front", "wrist"),
                                encoder_type="small")
    jax_params = jax.tree.map(np.asarray, jagent.state.params)
    cfg = WorkloadConfig.preset("drq_sim", image_size=SIZE, seed=1)
    agent = async_drq_sim.make_agent(cfg, "cpu")
    load_sac_params(agent, jax_params)
    _assert_published_equals(to_jax_layout(agent), jax_params)


# ---------------------------------------------------------------- actor


def _to_jax_single(state):
    """The port's one-env state as JAX's unbatched env state."""
    return jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x[0].numpy()) for x in state.physics)),
        t=jnp.asarray(state.t[0].numpy()), z_init=jnp.asarray(state.z_init[0].numpy()),
        rng=jax.random.PRNGKey(0), ep_id=jnp.asarray(state.ep_id[0].numpy()))


def test_torch_actor_transitions_match_jax_unbatched_step():
    """Four steps of one env with random actions, the last at t = 99 (the
    episode's end), each from the port's own state."""
    torch.set_num_threads(1)
    env, jenv = PandaPickCubeEnv(device="cpu"), jpick.PandaPickCubeEnv()
    jstep = jax.jit(jenv.step)
    jobs = jax.jit(lambda s: jpick.flatten_obs(jenv._obs(s)))
    g = torch.Generator().manual_seed(0)
    state, obs_d = env.reset(1, g)
    obs_np = flatten_obs(obs_d)[0].numpy()
    for i in range(4):
        if i == 3:
            state = state._replace(t=torch.full_like(state.t, 99))
        js = _to_jax_single(state)
        action = async_sac_state_sim.random_actions(1, g, "cpu")
        state, next_obs_d, reward, done, _ = env.step(state, action)
        tr, next_np = async_sac_state_sim.transition(obs_np, action, flatten_obs(next_obs_d),
                                                     reward, done)
        _, jo, jr, jd, _ = jstep(js, jnp.asarray(action[0].numpy()))
        np.testing.assert_allclose(tr["observations"], np.asarray(jobs(js)), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tr["next_observations"], np.asarray(jpick.flatten_obs(jo)),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tr["actions"], action[0].numpy())
        np.testing.assert_allclose(tr["rewards"], float(jr), atol=ATOL, rtol=0)
        assert tr["dones"] == float(jd) == float(i == 3) and tr["masks"] == 1.0 - float(jd)
        for k, v in async_sac_state_sim.example_transition().items():
            assert type(tr[k]) is type(v) and tr[k].shape == v.shape and tr[k].dtype == v.dtype
        obs_np = next_np


def test_torch_pixel_transition_has_the_jax_examples_layout():
    want = _jax_example("async_drq_sim")._example_transition(SIZE)
    env = PandaPickCubeEnv(image_obs=True, render_size=SIZE, device="cpu")
    g = torch.Generator().manual_seed(1)
    state, obs_d = env.reset(1, g)
    obs_np = async_drq_sim._host_obs(async_drq_sim._pixel_obs(obs_d))
    action = async_sac_state_sim.random_actions(1, g, "cpu")
    state, next_obs_d, reward, done, _ = env.step(state, action)
    next_obs = async_drq_sim._pixel_obs(next_obs_d)
    tr, _ = async_drq_sim.pixel_transition(obs_np, action, next_obs, reward, done)
    for layout in (tr, async_drq_sim._example_transition(SIZE)):
        got, ref = _paths(layout), _paths(want)
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(tr["next_observations"]["front"], next_obs["front"][0].numpy())
    assert tr["next_observations"]["front"].dtype == np.uint8


# ---------------------------------------------------------------- learner


def _fill(stores, n, example_fn, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tr = map_tree(lambda x: (rng.normal(size=np.shape(x)) if np.asarray(x).dtype != np.uint8
                                 else rng.integers(0, 256, np.shape(x))).astype(np.asarray(x).dtype),
                      example_fn())
        for store in stores:
            store.insert(tr)


def test_torch_sample_rlpd_equals_jax():
    example = lambda: async_drq_sim._example_transition(8)  # noqa: E731
    port, ref = [ReplayBufferDataStore(example(), 32) for _ in range(2)], \
        [JaxStore(example(), 32) for _ in range(2)]
    _fill([port[0], ref[0]], 40, example, 1)
    _fill([port[1], ref[1]], 20, example, 2)
    jmod = _jax_example("async_drq_sim")
    for seed in (0, 5):
        got = async_drq_sim._sample_rlpd(*port, 8, 4, np.random.default_rng(seed))
        want = jmod._sample_rlpd(*ref, 8, 4, np.random.default_rng(seed))
        _assert_published_equals(got, want)
        assert got["rewards"].shape == (32,)


def test_torch_learner_update_from_host_batch_matches_jax():
    torch.set_num_threads(1)
    example = async_sac_state_sim.example_transition
    port, ref = ReplayBufferDataStore(example(), 64), JaxStore(example(), 64)
    _fill([port, ref], 80, example, 3)
    rows, utd = 32, 2
    batch = next(port.get_iterator(rows, "cpu", rng=np.random.default_rng(9)))
    jbatch = ref.sample(rows, np.random.default_rng(9))
    _assert_published_equals({k: v.numpy() for k, v in batch.items()}, jbatch)
    agent = make_sac_agent(0, device="cpu")
    agent.init_train_state(OPT, OPT, OPT)
    # past Adam's first step, which is ill-conditioned from zero moments
    # (tests/test_torch_learner.py's docstring)
    agent.update_high_utd(next(port.get_iterator(rows, "cpu", rng=np.random.default_rng(8))),
                          utd_ratio=utd, generator=torch.Generator().manual_seed(0))
    before = train_state_to_jax_layout(agent)
    key = jax.random.PRNGKey(3)
    _, info = agent.update_high_utd(batch, utd_ratio=utd, draws=jax_high_utd_draws(
        key, rows, utd, ensemble=10, action_dim=4))
    jagent = jax_make_sac_agent(0, actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                                temperature_optimizer_kwargs=OPT)
    jnew, jinfo = jax_with_state(jagent, before, key).update_high_utd(
        {k: jnp.asarray(v) for k, v in jbatch.items()}, utd_ratio=utd)
    assert_states_close(train_state_to_jax_layout(agent), jax_state_np(jnew), atol=2e-6)
    np.testing.assert_allclose(float(info["critic"]["critic_loss"]),
                               float(jinfo["critic"]["critic_loss"]), rtol=1e-5)


# ---------------------------------------------------------------- two processes


@pytest.mark.parametrize("name", list(RUNS))
def test_torch_two_processes_train_and_share_params(runs, name):
    result = _finish(runs[name])
    (lrc, lout), (arc, aout) = result["learner"], result["actor"]
    assert lrc == 0, f"learner failed:\n{lout[-4000:]}"
    assert arc == 0, f"actor failed:\n{aout[-4000:]}"
    learner, actor = _summary(lout, "learner"), _summary(aout, "actor")
    training_starts = int(RUNS[name][1][RUNS[name][1].index("--training_starts") + 1])
    # the transitions reached the learner's ring before it trained
    assert learner["ring_at_start"] >= training_starts
    assert learner["transitions_received"] >= training_starts
    losses = [float(x) for x in re.findall(r"^update \d+ closs (\S+)", lout, re.M)]
    assert losses and all(math.isfinite(v) for v in losses) and learner["critic_loss_finite"]
    published = dict(re.findall(r"^learner published version (\d+) digest (\w+)", lout, re.M))
    loaded = re.findall(r"^actor loaded params digest (\w+)", aout, re.M)
    assert learner["publishes"] == len(published) >= 2
    assert actor["versions_loaded"] == len(loaded) >= 1
    assert set(loaded) <= set(published.values()), (loaded, published)
    assert actor["steps"] == int(RUNS[name][3][1]) and actor["episodes"] == 1
    if name == "pixels":
        assert "loaded 40 demo transitions" in lout
    # on the CPU every kernel wrapper took its plain version
    assert set(learner["launches"].values()) == set(actor["launches"].values()) == {0}
