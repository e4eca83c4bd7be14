"""The bin relocation env, its expert and the chained env against serl_tpu,
on the CPU.

- `BinRelocationEnv` (forward and backward): the reset with JAX's draws
  (the settle with the walls, then the cube placed in the source bin at
  rest, JAX's jitter: cube_pos to 1e-7), one step (dense and sparse
  reward, a cube delivered into the target bin in half the envs): physics
  under tests/torch_k1.py's per-env rule (the port's float64 run of the
  same control steps as the measure of rounding), rewards to 1e-4,
  success and done exactly.
- `relocation_expert_action` in float64 against JAX's under
  `jax.enable_x64` on states built at each branch of its state machine
  (approach, descend, grasp, carry, lower, closed on air): 1e-6.
- `ChainedBinEnv` with JAX's draws (its key chain: fold_in(rng, ep_id) split
  into the chained reset's draws): the reset (task drawn per env), and
  step_auto_reset where a success flips the task and keeps the cube, a time
  limit keeps the task, a lost cube gets a fresh reset and a re-drawn task,
  and a running env steps on: task, done, switched, success, t and ep_id
  exactly, rewards to 1e-5, physics under the rule. With per-task
  classifiers on the front camera (the same function in both frameworks)
  the classifiers' verdict drives the switch, compared only beyond 0.01 of
  the threshold (tests/test_torch_classifier_env.py's rule), on the
  stepped, pre-reset frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import chained_bin as jchained
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import scripted_expert as jexpert
from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import chained_bin, tasks
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.physics.arm import fk
from serl_tpu_torch.envs.scripted_expert import relocation_expert_action
from tests import torch_k1
from tests.torch_pose_jax import assert_physics_close, jax_reset_draws, to_jax

N, ATOL, MARGIN = 6, 1e-4, 0.01
LIMIT = 100


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spy(monkeypatch):
    """Records each control step's input state and obstacle table."""
    inputs = []
    control_step = engine.control_step

    def spy(p, obstacles=None):
        inputs.append((p, obstacles))
        return control_step(p, obstacles)

    monkeypatch.setattr(engine, "control_step", spy)
    return inputs


def _f64(p):
    return type(p)(*(x.double() for x in p))


def _settled(p, walls):
    for _ in range(tasks.SETTLE_STEPS):
        p = engine.control_step_plain(p, walls)
    return p


def _keys(seed, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


@pytest.mark.parametrize("task_id", [0, 1])
def test_torch_bin_reset_matches_jax(task_id, monkeypatch):
    env = tasks.BinRelocationEnv(task_id, device="cpu")
    jenv = jtasks.BinRelocationEnv(task_id=task_id)
    keys = _keys(3 + task_id)
    want = jax.jit(jax.vmap(jenv._reset_state))(keys)
    inputs = _spy(monkeypatch)
    got = env._reset_state(jax_reset_draws(keys, env.config, jitter=True))
    assert len(inputs) == tasks.SETTLE_STEPS and all(o is env.obstacles for _, o in inputs)
    # the cube is placed after the settle: at rest in the source bin
    np.testing.assert_allclose(got.physics.cube_pos.numpy(), np.asarray(want.physics.cube_pos),
                               atol=1e-7, rtol=0)
    assert (got.physics.cube_linvel == 0).all() and (got.physics.cube_angvel == 0).all()
    assert (tasks.bin_success(got.physics.cube_pos, env.source_bin()) == 1).all()
    np.testing.assert_array_equal(got.z_init.numpy(), np.asarray(want.z_init))
    # the settle ran with the pick env's cube (the placement keeps its orientation)
    exact = _settled(_f64(inputs[0][0]), env.obstacles)._replace(
        cube_pos=got.physics.cube_pos.double(), cube_linvel=got.physics.cube_linvel.double(),
        cube_angvel=got.physics.cube_angvel.double())
    assert_physics_close(got.physics, want.physics, exact)


@pytest.mark.parametrize("dense", [True, False])
def test_torch_bin_step_matches_jax(dense, monkeypatch):
    env = tasks.BinRelocationEnv(0, dense_shaping=dense, device="cpu")
    jenv = jtasks.BinRelocationEnv(task_id=0, dense_shaping=dense)
    state = env._reset_state(jax_reset_draws(_keys(5), env.config, jitter=True))
    # half the envs hold the cube delivered into the target bin: success
    target = env.target_bin()
    cube = state.physics.cube_pos.clone()
    cube[::2, :2] = target + torch.tensor([0.01, -0.02])
    state = state._replace(physics=state.physics._replace(cube_pos=cube))
    a = np.random.default_rng(6).uniform(-1.0, 1.0, (N, 7)).astype(np.float32)
    a[:, 6] = np.where(np.arange(N) % 3 == 0, 1.0, 0.0)  # the gripper moves in some envs
    inputs = _spy(monkeypatch)
    got, r, d, info = env._step_state(state, torch.from_numpy(a))
    js, jr, jd, ji = jax.jit(jax.vmap(jenv._step_state))(to_jax(state), jnp.asarray(a))
    assert len(inputs) == 1 and inputs[0][1] is env.obstacles
    assert_physics_close(got.physics, js.physics,
                         engine.control_step_plain(_f64(inputs[0][0]), env.obstacles))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(info["success"].numpy(), np.asarray(ji["success"]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert info["success"][::2].all() and not info["success"][1::2].any()
    assert (d.numpy()[::2] == (0.0 if dense else 1.0)).all()


def _expert_states(n=24):
    """float64 states at each branch of the relocation expert: arms near
    home with the cube placed relative to the pinch (far above: approach;
    aligned below: descend and grasp; closed and lifted: carry; closed over
    the target: lower; closed with no cube: open), with each env's target bin."""
    g = torch.Generator().manual_seed(7)
    s = torch_k1.reset_states(n, g, "cpu")
    q = s.qpos + 0.1 * (2.0 * torch.rand((n, 7), generator=g) - 1.0)
    tcp = fk(q).pinch_pos
    branch = torch.arange(n) % 6
    tgt = torch.tensor(tasks.FW_BIN)
    off = torch.tensor([[0.05, 0.03, -0.10],    # approach: far in xy
                        [0.003, -0.002, -0.030],  # aligned, above: descend
                        [0.002, 0.001, -0.005],   # aligned and low: grasp
                        [0.004, 0.002, -0.010],   # closed around it (carry)
                        [0.004, 0.002, -0.010],   # closed, over the target (lower / release)
                        [0.20, 0.10, -0.05]])[branch]
    cube = tcp + off
    theta = torch.where(branch >= 3, 0.5, 0.0)
    # per env target bins; branch 4's 5 mm from its pinch: over the target, lower
    tgt = torch.where((branch == 4)[:, None], tcp[:, :2] + 0.005, tgt)
    return s._replace(qpos=q, qvel=0.05 * (2.0 * torch.rand((n, 7), generator=g) - 1.0),
                      theta=theta, cube_pos=cube), branch, tgt


def test_torch_relocation_expert_matches_jax():
    s, branch, tgt = _expert_states()
    f64 = torch_k1.to_f64(s)
    from serl_tpu_torch.envs.panda_pick import EnvState

    n = s.qpos.shape[0]
    state = EnvState(f64, torch.zeros(n, dtype=torch.int32), torch.zeros(n),
                     torch.zeros(n, dtype=torch.int32))
    scale = tasks.bin_config(0).action_scale
    got = relocation_expert_action(state, tgt.double(), scale).numpy()
    with jax.enable_x64(True):
        jstate = jpick.EnvState(
            physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in f64)),
            t=jnp.zeros(n, jnp.int32), z_init=jnp.zeros(n), rng=_keys(0, n),
            ep_id=jnp.zeros(n, jnp.int32))
        want = np.asarray(jax.vmap(jexpert.relocation_expert_action, in_axes=(0, 0, None))(
            jstate, jnp.asarray(tgt.double().numpy()), jnp.asarray(scale)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # every branch's grip: open to approach, close to grasp and carry, open on air
    assert (got[branch.numpy() == 0, 6] == -1).all() and (got[branch.numpy() == 2, 6] == 1).all()
    assert (got[branch.numpy() == 3, 6] == 1).all() and (got[branch.numpy() == 5, 6] == -1).all()
    # float32 through the port agrees
    got32 = relocation_expert_action(state._replace(physics=s), tgt, scale).numpy()
    assert (got[branch.numpy() == 4, 6] == 1).all()  # held over the target, not yet low
    np.testing.assert_allclose(got32, got, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- chained


def jax_chain_draws(keys) -> chained_bin.ChainDraws:
    """The draws of ChainedBinEnv._chain_or_fresh_reset from the (N, 2) keys
    fold_in(rng, ep_id) (JAX's per-env chain)."""

    def one(k):
        k_xy, k_cube, k_fresh, _ = jax.random.split(k, 4)
        dxy = jax.random.uniform(k_xy, (2,), minval=-0.05, maxval=0.05)
        jitter = jax.random.uniform(k_cube, (2,), minval=-0.038, maxval=0.038)
        k_fresh, k_task = jax.random.split(k_fresh)
        return dxy, jitter, jax.random.uniform(k_fresh), jax.random.randint(k_task, (), 0, 2)

    return chained_bin.ChainDraws(*(torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys)))


def _chained_reset(env, keys):
    """The port's reset with the draws of JAX's ChainedBinEnv.reset(key)."""
    split = jax.vmap(jax.random.split)(keys)
    k_task, k_env = split[:, 0], split[:, 1]
    task = torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.randint(k, (), 0, 2))(k_task)))
    return env.reset(keys.shape[0], draws=jax_reset_draws(k_env, env.fw.config, jitter=True),
                     task_draw=task)


def test_torch_chained_reset_matches_jax(monkeypatch):
    env = chained_bin.ChainedBinEnv(fresh_reset_prob=0.1, device="cpu")
    jenv = jchained.ChainedBinEnv(fresh_reset_prob=0.1)
    keys = _keys(8, 8)
    want, _ = jax.jit(jax.vmap(jenv.reset))(keys)
    inputs = _spy(monkeypatch)
    got, _ = _chained_reset(env, keys)
    np.testing.assert_array_equal(got.task.numpy(), np.asarray(want.task))
    assert 0 < int(got.task.sum()) < 8  # both tasks drawn
    exact = _settled(_f64(inputs[0][0]), env.obstacles)._replace(
        cube_pos=got.env.physics.cube_pos.double(),
        cube_linvel=got.env.physics.cube_linvel.double(),
        cube_angvel=got.env.physics.cube_angvel.double())
    assert_physics_close(got.env.physics, want.env.physics, exact)


def _case_state(env, jkeys):
    """N envs at the step cases: 0 forward, cube in the forward bin
    (success: flip to backward); 1 backward, cube in the backward bin (flip);
    2 forward at the time limit, cube in its source bin (retry); 3 forward,
    cube lost beyond the arm's reach (fresh reset, task re-drawn); 4
    backward, running; 5 forward, running."""
    state, _ = _chained_reset(env, jkeys)
    task = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.int32)
    fw, bw = torch.tensor(tasks.FW_BIN), torch.tensor(tasks.BW_BIN)
    xy = torch.stack([fw + 0.01, bw - 0.01, bw, torch.tensor([0.6, 0.0]), fw, bw])
    phys = state.env.physics
    cube = torch.cat([xy, torch.full((N, 1), tasks.CUBE_REST_Z)], -1)
    phys = phys._replace(cube_pos=cube, cube_linvel=torch.zeros(N, 3),
                         cube_angvel=torch.zeros(N, 3))
    t = torch.tensor([3, 3, LIMIT - 1, 3, 3, 3], dtype=torch.int32)
    ep_id = torch.tensor([0, 2, 1, 5, 0, 3], dtype=torch.int32)
    return chained_bin.ChainedState(state.env._replace(physics=phys, t=t, ep_id=ep_id), task)


def _step_both(env, jenv, state, rng, actions, monkeypatch):
    inputs = _spy(monkeypatch)
    draws = jax_chain_draws(jax.vmap(jax.random.fold_in)(rng, jnp.asarray(state.env.ep_id.numpy())))
    got = env.step_auto_reset(state, torch.from_numpy(actions), draws=draws)
    jstate = jchained.ChainedState(env=to_jax(state.env, rng), task=jnp.asarray(state.task.numpy()))
    want = jax.jit(jax.vmap(jenv.step_auto_reset))(jstate, jnp.asarray(actions))
    return got, want, inputs, draws


def _assert_step(env, got, want, inputs):
    (gs, _, gr, gd, gi), (ws, _, wr, wd, wi) = got, want
    np.testing.assert_array_equal(gs.task.numpy(), np.asarray(ws.task))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for k in ("success_gt", "task", "switched"):
        np.testing.assert_array_equal(gi[k].numpy(), np.asarray(wi[k]), err_msg=k)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gs.env.t.numpy(), np.asarray(ws.env.t))
    np.testing.assert_array_equal(gs.env.ep_id.numpy(), np.asarray(ws.env.ep_id))
    # the next states: stepped where running, reset and settled where ended
    assert len(inputs) == 1 + tasks.SETTLE_STEPS  # the step, then every env's reset
    done = torch.from_numpy(np.asarray(wd) > 0.5)
    stepped = engine.control_step_plain(_f64(inputs[0][0]), env.obstacles)
    settled = _settled(_f64(inputs[1][0]), env.obstacles)
    exact = engine.PhysicsState(*(torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), b, a)
                                  for a, b in zip(stepped, settled)))
    assert_physics_close(gs.env.physics, ws.env.physics, exact)


def test_torch_chained_step_matches_jax(monkeypatch):
    env = chained_bin.ChainedBinEnv(fresh_reset_prob=0.1, device="cpu")
    jenv = jchained.ChainedBinEnv(fresh_reset_prob=0.1)
    rng = _keys(11)
    state = _case_state(env, _keys(12))
    actions = np.zeros((N, 7), np.float32)
    actions[:, 2] = 0.2  # the arm rises a little; the gripper stays
    got, want, inputs, draws = _step_both(env, jenv, state, rng, actions, monkeypatch)
    _assert_step(env, got, want, inputs)
    out, _, _, done, info = got
    np.testing.assert_array_equal(done.numpy(), [1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(info["switched"].numpy(),
                                  [True, True, False, False, False, False])
    fresh = (draws.fresh < env.fresh_reset_prob).numpy()
    np.testing.assert_array_equal(out.task[:3].numpy(),
                                  np.where(fresh[:3], draws.task[:3].numpy(), [1, 0, 0]))
    # a flip keeps the cube where it was delivered (unless a fresh reset was
    # drawn); the arm goes to the new task's pose
    kept = np.flatnonzero(~fresh[:2])
    np.testing.assert_allclose(out.env.physics.cube_pos[kept, :2].numpy(),
                               state.env.physics.cube_pos[kept, :2].numpy(), atol=1e-3)
    assert (out.env.physics.grip_ctrl[:3] == 0).all() and (out.env.t[:3] == 0).all()
    # a lost cube ends its episode at the time limit only, then gets a fresh reset
    state = state._replace(env=state.env._replace(t=torch.full((N,), LIMIT - 1, dtype=torch.int32)))
    got, want, inputs, draws = _step_both(env, jenv, state, rng, actions, monkeypatch)
    _assert_step(env, got, want, inputs)
    out = got[0]
    assert out.task[3] == draws.task[3]  # the re-drawn task
    src = env._sources[out.task[3].long()]
    assert tasks.bin_success(out.env.physics.cube_pos[3:4], src)[0] == 1  # re-placed


class _MeanFront:
    """A stand-in classifier: a logit from the front frame's mean level
    about `centre`, one function for the JAX env ((H, W, 3) -> ()) and the
    port's ({"front": (N, 1, H, W, 3)} -> (N,))."""

    def __init__(self, scale, centre):
        self.scale, self.centre = scale, centre

    def jax(self, img):
        return self.scale * (img.astype(jnp.float32).mean() - self.centre)

    def __call__(self, obs):
        x = obs["front"].to(torch.float32)
        return self.scale * (x.reshape(x.shape[0], -1).mean(-1) - self.centre)


def test_torch_chained_classifier_drives_the_switch(monkeypatch):
    from serl_tpu_torch.envs.rendering import render_cameras

    state_env = chained_bin.ChainedBinEnv(render_size=32, fresh_reset_prob=0.0, device="cpu")
    state = _case_state(state_env, _keys(12))
    stepped, _ = state_env.fw._apply_action(state.env, torch.zeros(N, 7))
    frames = render_cameras(stepped.physics, 32)[0].unsqueeze(1)
    # logits spread over a few units about the envs' median level
    level = frames.float().reshape(N, -1).mean(-1)
    scale = 3.0 / float(level.std())
    fw, bw = _MeanFront(scale, float(level.median())), _MeanFront(-scale, float(level.median()))
    logits = fw({"front": frames}).numpy()
    s = np.sort(logits.astype(np.float64))
    i = int(np.argmax(np.diff(s)))
    threshold = float(1.0 / (1.0 + np.exp(-0.5 * (s[i] + s[i + 1]))))
    seen = []

    def watch(obs, fn=fw):
        seen.append(obs["front"].clone())
        return fn(obs)

    env = chained_bin.ChainedBinEnv(render_size=32, fresh_reset_prob=0.0,
                                    classifier_fns=(watch, bw), classifier_threshold=threshold,
                                    device="cpu")
    jenv = jchained.ChainedBinEnv(render_size=32, fresh_reset_prob=0.0,
                                  classifier_fns=(fw.jax, bw.jax), classifier_threshold=threshold)
    got, want, _, _ = _step_both(env, jenv, state, _keys(11), np.zeros((N, 7), np.float32),
                                 monkeypatch)
    # the classifier saw the stepped, pre-reset frame
    assert len(seen) == 1 and torch.equal(seen[0], frames)
    p_fw = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    p_bw = 1.0 / (1.0 + np.exp(-bw({"front": frames}).numpy().astype(np.float64)))
    p = np.where(state.task.numpy() == 0, p_fw, p_bw)
    clear = np.abs(p - threshold) > MARGIN
    assert clear.sum() >= N // 2
    (gs, _, gr, gd, gi), (ws, _, wr, wd, wi) = got, want
    for a, b in ((gi["success"], wi["success"]), (gd, wd), (gs.task, ws.task),
                 (gi["switched"], wi["switched"])):
        np.testing.assert_array_equal(a.numpy()[clear], np.asarray(b)[clear])
    np.testing.assert_array_equal(gi["success"].numpy(), (p >= threshold).astype(np.float32))
    # the ground truth stays beside the driving success
    np.testing.assert_array_equal(gi["success_gt"].numpy(), np.asarray(wi["success_gt"]))
