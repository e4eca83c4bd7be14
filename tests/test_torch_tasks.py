"""The port's pose tasks (envs/tasks.py) against serl_tpu's, on the CPU.

The JAX env is single-env and vmapped; the port steps all envs at once.
Every reset takes JAX's own draws (tests/torch_pose_jax.py replays its key
splits), and the port's state is handed to JAX before each compared step.
Physics is held per env by tests/torch_k1.py's rule, angles modulo 2 pi
(the task's roll sits at atan2's +-pi flip) at 1e-5, the tcp pose's Euler
angles at 1e-5 plus 3x the port's float32-vs-float64 spread at that state
(tests/torch_pose_jax.py::assert_pose_close). Where a test is about
the action, reset or episode logic and not the physics, both frameworks'
control step is replaced by the identity (the physics has its own tests),
which holds that logic to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs import wrappers as jwrappers
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import tasks, wrappers
from serl_tpu_torch.envs.panda_pick import flatten_obs
from serl_tpu_torch.envs.physics import engine
from tests import torch_k2
from tests.torch_pose_jax import (
    assert_angles_close,
    assert_physics_close,
    assert_pose_close,
    jax_reset_draws,
    to_jax,
    to_torch,
)

CONFIGS = {"peg": (tasks.PEG_INSERT_CONFIG, jtasks.PEG_INSERT_CONFIG),
           "pcb": (tasks.PCB_INSERT_CONFIG, jtasks.PCB_INSERT_CONFIG)}
N = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_physics(monkeypatch):
    """Both frameworks' control step as the identity."""
    monkeypatch.setattr(engine, "control_step", lambda p, obstacles=None: p)
    monkeypatch.setattr(jengine, "control_step", lambda p, obstacles=None: p)


def _keys(seed, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _envs(name="peg", **overrides):
    port_cfg, jax_cfg = CONFIGS[name]
    return (tasks.PandaPoseTaskEnv(port_cfg._replace(**overrides), device="cpu"),
            jtasks.PandaPoseTaskEnv(jax_cfg._replace(**overrides)))


def test_torch_pose_configs_equal_jax():
    assert tasks.PoseTaskConfig._fields == jtasks.PoseTaskConfig._fields
    assert tuple(tasks.PoseTaskConfig()) == tuple(jtasks.PoseTaskConfig())
    for name in ("PEG_INSERT_CONFIG", "PCB_INSERT_CONFIG", "CABLE_ROUTE_CONFIG"):
        assert tuple(getattr(tasks, name)) == tuple(getattr(jtasks, name)), name
    # the bin relocation task's configs (forward and backward) equal JAX's
    for task_id in (0, 1):
        want = jtasks.BinRelocationEnv(task_id=task_id).config
        assert tuple(tasks.bin_config(task_id)) == tuple(want), task_id
        assert tuple(tasks.BinRelocationEnv(task_id, device="cpu").config) == tuple(want)


def test_torch_quat_euler_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # the tasks' orientations: roll at +-pi (just either side of the flip)
    eul = np.stack([np.pi + rng.uniform(-1e-3, 1e-3, 64), rng.uniform(-0.05, 0.05, 64),
                    rng.uniform(-0.6, 0.6, 64)], -1).astype(np.float32)
    q_task = np.asarray(jwrappers.euler_to_quat(jnp.asarray(eul)))
    for quats in (q, q_task, -q_task):
        got = wrappers.quat_to_euler(torch.tensor(quats)).numpy()
        want = np.asarray(jwrappers.quat_to_euler(jnp.asarray(quats)))
        assert_angles_close(got, want, err_msg="quat_to_euler")
    np.testing.assert_allclose(wrappers.euler_to_quat(torch.from_numpy(eul)).numpy(), q_task,
                               atol=1e-6, rtol=0)
    # the round trip, through the flip
    back = wrappers.quat_to_euler(wrappers.euler_to_quat(torch.from_numpy(eul))).numpy()
    assert_angles_close(back, eul, atol=2e-3, err_msg="round trip")  # pitch near 0: float32 asin
    assert (back[:, 0] > 0).any() and (back[:, 0] < 0).any()  # both sides of +-pi occur


def test_torch_pose_reset_settles_like_jax(monkeypatch):
    env, jenv = _envs("peg")
    keys = _keys(1)
    want = jax.jit(jax.vmap(jenv._reset_state))(keys)
    steps = []
    control_step = engine.control_step

    def spy(p, obstacles=None):
        steps.append(p)
        return control_step(p, obstacles)

    monkeypatch.setattr(engine, "control_step", spy)
    got = env._reset_state(jax_reset_draws(keys, tasks.PEG_INSERT_CONFIG))
    assert len(steps) == tasks.SETTLE_STEPS
    exact = type(steps[0])(*(x.double() for x in steps[0]))
    for _ in range(tasks.SETTLE_STEPS):
        exact = engine.control_step_plain(exact)
    assert_physics_close(got.physics, want.physics, exact)
    np.testing.assert_array_equal(got.t.numpy(), 0)
    np.testing.assert_array_equal(got.ep_id.numpy(), 0)
    np.testing.assert_array_equal(got.z_init.numpy(), np.asarray(want.z_init))
    # the settle moves the pinch from home down toward the reset pose
    home_z = engine.fk(steps[0].qpos).pinch_pos[:, 2]
    assert (engine.fk(got.physics.qpos).pinch_pos[:, 2] < home_z - 0.01).all()


def _box_states(env, cfg, seed):
    """Reset states whose mocap targets sit at the corners and centre of the
    position and Euler boxes, with random grip commands."""
    rng = np.random.default_rng(seed)
    state = env._reset_state(env.sample_reset_draws(N, torch.Generator().manual_seed(seed)))
    lo, hi = np.asarray(cfg.rot_lo), np.asarray(cfg.rot_hi)
    eul = np.stack([lo, hi, 0.5 * (lo + hi), np.where([1, 0, 1], lo, hi)]).astype(np.float32)
    clo, chi = np.asarray(cfg.cartesian_lo), np.asarray(cfg.cartesian_hi)
    pos = np.stack([clo, chi, 0.5 * (clo + chi), np.where([0, 1, 0], clo, chi)]).astype(np.float32)
    phys = state.physics._replace(
        mocap_pos=torch.from_numpy(pos),
        mocap_quat=wrappers.euler_to_quat(torch.from_numpy(eul)),
        grip_ctrl=torch.from_numpy(rng.uniform(0, 255, N).astype(np.float32)))
    return state._replace(physics=phys)


@pytest.mark.parametrize("name", ["peg", "pcb"])
def test_torch_pose_apply_action_at_the_box_edges_matches_jax(no_physics, name):
    env, jenv = _envs(name)
    cfg = env.config
    japply = jax.jit(jax.vmap(jenv._apply_action))
    rng = np.random.default_rng(2)
    state = _box_states(env, cfg, 3)
    lo, hi = np.asarray(cfg.rot_lo), np.asarray(cfg.rot_hi)
    for i in range(4):
        a = rng.uniform(-1.3, 1.3, (N, 7)).astype(np.float32)  # outside [-1, 1] too
        a[0, 3:6] = 0.0 if i == 0 else 1.0  # no rotation (the 1e-9 angle), then the box's edge
        a[1, 3:6] = [-1.0, 1.0, -1.0]
        js, jmoved = japply(to_jax(state), jnp.asarray(a))
        got, moved = env._apply_action(state, torch.from_numpy(a))
        np.testing.assert_allclose(got.physics.mocap_pos.numpy(), np.asarray(js.physics.mocap_pos),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.physics.mocap_quat.numpy(),
                                   np.asarray(js.physics.mocap_quat), atol=2e-6, rtol=0)
        np.testing.assert_allclose(got.physics.grip_ctrl.numpy(), np.asarray(js.physics.grip_ctrl),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(moved.numpy(), np.asarray(jmoved))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(js.t))
        # the target stays inside its boxes (Euler angles unwrapped toward the box centre)
        eul = wrappers.quat_to_euler(got.physics.mocap_quat).numpy()
        eul += 2 * np.pi * np.round((0.5 * (lo + hi) - eul) / (2 * np.pi))
        assert (eul >= lo - 1e-5).all() and (eul <= hi + 1e-5).all()
        assert (got.physics.mocap_pos.numpy() >= np.asarray(cfg.cartesian_lo) - 1e-7).all()
        state = got
    assert moved.any() and not moved.all()


def test_torch_pose_step_matches_jax(monkeypatch):
    env, jenv = _envs("peg")
    jstep = jax.jit(jax.vmap(jenv._step_state))
    state = env._reset_state(jax_reset_draws(_keys(4), tasks.PEG_INSERT_CONFIG))
    inputs = []
    control_step = engine.control_step
    monkeypatch.setattr(engine, "control_step",
                        lambda p, obstacles=None: inputs.append(p) or control_step(p))
    rng = np.random.default_rng(5)
    for _ in range(2):
        a = rng.uniform(-1.0, 1.0, (N, 7)).astype(np.float32)
        js, jr, jd, ji = jstep(to_jax(state), jnp.asarray(a))
        got, r, d, info = env._step_state(state, torch.from_numpy(a))
        exact = engine.control_step_plain(type(inputs[-1])(*(x.double() for x in inputs[-1])))
        assert_physics_close(got.physics, js.physics, exact)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(ji["success"]))
        state = got


def _pose_of(env, state):
    return env._pose(engine.fk(state.physics.qpos)).numpy()


def test_torch_pose_success_reward_and_early_end_match_jax(no_physics):
    """Targets placed around env 0's pose: inside and outside each threshold,
    the roll across the +-pi wrap; a gripper penalty on gripper moves."""
    env, _ = _envs("peg")
    state = env._reset_state(jax_reset_draws(_keys(6), tasks.PEG_INSERT_CONFIG))
    pose0 = _pose_of(env, state)[0].astype(np.float64)
    thr = np.asarray(tasks.PEG_INSERT_CONFIG.reward_threshold)
    wrapped = pose0.copy()
    wrapped[3] -= np.sign(pose0[3]) * 2 * np.pi  # the same roll on the other side of the flip
    cases = {"at": pose0, "inside": pose0 + 0.5 * thr, "outside_z": pose0 + [0, 0, 1.5 * thr[2], 0, 0, 0],
             "outside_yaw": pose0 + [0, 0, 0, 0, 0, 1.5 * thr[5]], "wrapped_roll": wrapped}
    rng = np.random.default_rng(7)
    a = rng.uniform(-1.0, 1.0, (N, 7)).astype(np.float32)
    a[:, :6] = 0.0
    a[:2, 6] = [1.0, -0.1]  # env 0 moves its gripper by more than 0.25, env 1 not
    state = state._replace(physics=state.physics._replace(grip_ctrl=torch.zeros(N)))
    successes = {}
    for case, target in cases.items():
        env, jenv = _envs("peg", target_pose=tuple(float(x) for x in target), gripper_penalty=0.1)
        js, jr, jd, ji = jax.vmap(jenv._step_state)(to_jax(state), jnp.asarray(a))
        got, r, d, info = env._step_state(state, torch.from_numpy(a))
        np.testing.assert_array_equal(info["success"].numpy(), np.asarray(ji["success"]), case)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-7, rtol=0, err_msg=case)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd), case)
        successes[case] = float(info["success"][0])
    assert successes == {"at": 1.0, "inside": 1.0, "outside_z": 0.0, "outside_yaw": 0.0,
                         "wrapped_roll": 1.0}


@pytest.mark.parametrize("pixels", [False, True])
def test_torch_pose_obs_matches_jax(pixels):
    env = tasks.PandaPoseTaskEnv(tasks.PEG_INSERT_CONFIG, image_obs=pixels, render_size=32,
                                 device="cpu")
    jenv = jtasks.PandaPoseTaskEnv(jtasks.PEG_INSERT_CONFIG, image_obs=pixels, render_size=32)
    state = env._reset_state(jax_reset_draws(_keys(8), tasks.PEG_INSERT_CONFIG))
    got, want = env._obs(state), jax.jit(jax.vmap(jenv._obs))(to_jax(state))
    assert sorted(got["state"]) == sorted(want["state"])
    assert_pose_close(got["state"]["tcp_pose"], want["state"]["tcp_pose"], state.physics.qpos)
    for k in ("tcp_vel", "gripper_pose") + (() if pixels else ("block_pos",)):
        np.testing.assert_allclose(got["state"][k].numpy(), np.asarray(want["state"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    width = flatten_obs(got).shape[-1]
    assert width == (tasks.PIXEL_STATE_DIM if pixels else tasks.STATE_OBS_DIM)
    if pixels:
        for k in ("front", "wrist"):
            failures, _ = torch_k2.pixel_rule(got["images"][k],
                                              torch.from_numpy(np.array(want["images"][k])))
            assert not failures, (k, failures)


def test_torch_pose_step_auto_reset_matches_jax(no_physics):
    """Env 0 ends at the time limit, env 2 early on success (its target is
    its own pose), envs 1 and 3 run on; resets take JAX's draws from
    fold_in(rng, ep_id), as JAX's step_auto_reset does."""
    env, _ = _envs("peg")
    state = env._reset_state(jax_reset_draws(_keys(9), tasks.PEG_INSERT_CONFIG))
    # without physics every env sits at home: move the arms of envs 0, 1, 3 apart
    offsets = torch.tensor([[0.03], [-0.03], [-0.08], [0.06]]) * torch.ones(1, 7)
    state = state._replace(physics=state.physics._replace(qpos=state.physics.qpos + offsets))
    target = tuple(float(x) for x in _pose_of(env, state)[2])
    env, jenv = _envs("peg", target_pose=target)
    limit = env.time_limit_steps
    state = state._replace(t=torch.tensor([limit - 1, 5, 3, 0], dtype=torch.int32),
                           ep_id=torch.tensor([3, 1, 0, 7], dtype=torch.int32))
    rng = _keys(10)
    a = np.random.default_rng(11).uniform(-0.2, 0.2, (N, 7)).astype(np.float32)
    a[2] = 0.0
    js, jo, jr, jd, ji = jax.vmap(jenv.step_auto_reset)(to_jax(state, rng), jnp.asarray(a))
    draws = jax_reset_draws(jax.vmap(jax.random.fold_in)(rng, jnp.asarray(state.ep_id.numpy())),
                            env.config)
    new, obs, r, d, info = env.step_auto_reset(state, torch.from_numpy(a), draws=draws)
    np.testing.assert_array_equal(d.numpy(), [1.0, 0.0, 1.0, 0.0])
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(info["success"].numpy(), [0.0, 0.0, 1.0, 0.0])
    want = to_torch(js)
    np.testing.assert_array_equal(new.t.numpy(), [0, 6, 0, 1])
    np.testing.assert_array_equal(new.ep_id.numpy(), want.ep_id.numpy())
    np.testing.assert_array_equal(new.ep_id.numpy(), [4, 1, 1, 7])
    for f in new.physics._fields:
        np.testing.assert_allclose(getattr(new.physics, f).numpy(),
                                   getattr(want.physics, f).numpy(), atol=2e-6, rtol=0, err_msg=f)
    np.testing.assert_array_equal(new.z_init.numpy(), want.z_init.numpy())
    # the observations: the pre-reset ones of every env and the running envs'
    # next ones against JAX's; a reset env's is its fresh state's (which sits
    # at home without physics, where the Euler angles are singular)
    run = [1, 3]
    for got_obs, want_obs, rows, qpos in ((info["final_obs"], ji["final_obs"], slice(None),
                                           state.physics.qpos), (obs, jo, run, new.physics.qpos)):
        assert_pose_close(got_obs["state"]["tcp_pose"][rows],
                          np.asarray(want_obs["state"]["tcp_pose"])[rows], qpos[rows])
        for k in ("tcp_vel", "gripper_pose", "block_pos"):
            np.testing.assert_allclose(got_obs["state"][k].numpy()[rows],
                                       np.asarray(want_obs["state"][k])[rows], atol=1e-5, rtol=0)
    for k, v in env._obs(new)["state"].items():
        assert torch.equal(obs["state"][k], v), k


def test_torch_pose_demo_reset_bank_matches_jax(no_physics):
    env, jenv = _envs("pcb")
    m, n = 6, 8
    bank = env._reset_state(jax_reset_draws(_keys(12, m), env.config))
    bank = bank._replace(z_init=torch.linspace(0.02, 0.07, m),
                         t=torch.arange(m, dtype=torch.int32) + 10)
    env.set_demo_reset_bank(bank, 0.5)
    jenv.set_demo_reset_bank(to_jax(bank), 0.5)
    keys = _keys(13, n)
    want = to_torch(jax.vmap(jenv._reset_state)(keys))
    draws = jax_reset_draws(keys, env.config, bank_size=m)
    got = env._reset_state(draws)
    use = (draws.use < 0.5).numpy()
    assert use.any() and not use.all()
    for f in got.physics._fields:
        np.testing.assert_allclose(getattr(got.physics, f).numpy(),
                                   getattr(want.physics, f).numpy(), atol=2e-6, rtol=0, err_msg=f)
        np.testing.assert_array_equal(getattr(got.physics, f).numpy()[use],
                                      getattr(bank.physics, f).numpy()[draws.idx.numpy()[use]])
    np.testing.assert_array_equal(got.z_init.numpy(), want.z_init.numpy())
    np.testing.assert_array_equal(got.t.numpy(), 0)  # the episode clock stays the fresh one
    np.testing.assert_array_equal(got.ep_id.numpy(), 0)
    # from the env's own generator, the bank draws come too
    sampled = env.sample_reset_draws(n, torch.Generator().manual_seed(0))
    assert sampled.idx.shape == (n,) and int(sampled.idx.max()) < m and sampled.use.shape == (n,)
