"""The port's physics (serl_tpu_torch.envs.physics) against serl_tpu's, on the CPU.

Inputs come from numpy seeds and go through the JAX function (vmapped over
envs) and the port's batched counterpart. Tolerances:
  * linalg_small, fk, mass matrix, bias forces: 1e-5 abs + 1e-5 relative —
    float32 rounding of products and sums in another order;
  * contact forces: 2e-3 N abs (pad forces reach ~6 N) — the pad depth is a
    difference of two ~2 cm lengths under an 8000 N/m spring, and friction
    turns through tanh(|v_t| / 3 mm/s); each float32 implementation lies
    ~5e-4 N from a float64 run of the same code;
  * opspace torques: 5e-3 N m (torques reach 87 N m) — mat_to_quat recovers
    the near-zero quaternion components of the near-180-degree target from
    their own square roots, so float32 rounding moves the orientation error
    by ~4e-5 rad, which the kp_ori = 200 gain and task-space inertia amplify;
  * one control step: the per-env rule of tests/torch_k1.py (STEP_ATOL plus
    3x the port's own float32-vs-float64 spread, capped by STEP_CAP; see
    there), which holds the kernel's code, built for the CPU, to the plain
    version as well;
  * a 100-step rollout: torch_k1.DRIFT_ATOL for the controlled arm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import arm as jarm
from serl_tpu.envs.physics import engine as jengine
from serl_tpu.envs.physics import linalg_small as jlin
from serl_tpu.envs.physics import opspace as jops
from serl_tpu_torch.envs.physics import arm, engine, linalg_small, opspace
from tests import torch_k1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _jv(fn):
    return jax.jit(jax.vmap(fn))


def _jax_state(s):
    return jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in s))


def _torch_state(s):
    return engine.PhysicsState(*(_t(x) for x in s))


@pytest.fixture(scope="module")
def jax_control_step():
    return jax.jit(jax.vmap(jengine.control_step))


@pytest.mark.parametrize("n", [3, 6, 7])
def test_torch_linalg_small_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(16, n, n)).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(16, n)).astype(np.float32)
    B = rng.normal(size=(16, n, 5)).astype(np.float32)
    _close(linalg_small.solve_spd(_t(m), _t(b)), jlin.solve_spd(m, b))
    _close(linalg_small.solve_spd_mat(_t(m), _t(B)), jlin.solve_spd_mat(m, B))
    _close(linalg_small.inv_spd(_t(m)), jlin.inv_spd(m))
    _close(linalg_small.det_spd(_t(m)), jlin.det_spd(m), rtol=1e-5, atol=0)
    a3, b3 = a[:, :3, :3] + 3 * np.eye(3, dtype=np.float32), b[:, :3]
    _close(linalg_small.solve3(_t(a3), _t(b3)), jlin.solve3(a3, b3))


def test_torch_det_spd_saturates_like_jax():
    m = np.zeros((2, 6, 6), np.float32)  # singular: the pivot clamp decides
    np.testing.assert_array_equal(linalg_small.det_spd(_t(m)).numpy(), np.asarray(jlin.det_spd(m)))


def _random_configs(seed, n=32):
    rng = np.random.default_rng(seed)
    q = (jengine._Q_HOME + rng.normal(0.0, 0.4, (n, 7))).astype(np.float32)
    qd = rng.normal(0.0, 0.8, (n, 7)).astype(np.float32)
    return q, qd


def test_torch_arm_dynamics_match_jax():
    q, qd = _random_configs(0)
    kj = _jv(jarm.fk)(jnp.asarray(q))
    kt = arm.fk(_t(q))
    for f in kj._fields:
        _close(getattr(kt, f), getattr(kj, f))
    _close(arm.point_jacobian(kt, kt.pinch_pos), _jv(jarm.point_jacobian)(kj, kj.pinch_pos))
    _close(arm.mass_matrix(kt), _jv(jarm.mass_matrix)(kj))
    _close(arm.bias_forces(kt, _t(qd)), _jv(jarm.bias_forces)(kj, jnp.asarray(qd)))
    for got, want in zip(arm.pinch_velocity(kt, _t(qd)),
                         _jv(jarm.pinch_velocity)(kj, jnp.asarray(qd))):
        _close(got, want)


def test_torch_opspace_torques_match_jax():
    q, qd = _random_configs(1)
    rng = np.random.default_rng(2)
    target = rng.uniform([0.3, -0.2, 0.1], [0.5, 0.2, 0.4], (len(q), 3)).astype(np.float32)
    quat = np.tile(np.float32([0.0, 1.0, 0.0, 0.0]), (len(q), 1))
    def torques(q, qd, target, quat):
        k = jarm.fk(q)
        M = jarm.mass_matrix(k)
        return jops.opspace_torques(k, M, jarm.bias_forces(k, qd), q, qd, target, quat)

    want = _jv(torques)(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(target), jnp.asarray(quat))
    kt = arm.fk(_t(q))
    got = opspace.opspace_torques(kt, arm.mass_matrix(kt), arm.bias_forces(kt, _t(qd)),
                                  _t(q), _t(qd), _t(target), _t(quat))
    _close(got, want, atol=5e-3, rtol=0)
    assert np.abs(np.asarray(want)).max() > 1.0  # the comparison is not of zeros


def _contact_states(n=16):
    """Grasp states (all 4 pad points active) and rollout states (cubes
    resting on the floor), built as chip_smoke.py builds them."""
    g = torch.Generator().manual_seed(0)
    return {"grasp": torch_k1.grasp_states(n, g, "cpu"),
            "rollout": torch_k1.rollout_states(n, g, "cpu", steps=3)}


def test_torch_contacts_match_jax():
    for name, s in _contact_states().items():
        js = _jax_state(s)
        floor, pad = engine.active_contacts(s)
        assert int(floor.sum() + pad.sum()) > 0, name
        got = engine._floor_contact(s)[:2]
        want = _jv(jengine._floor_contact)(js)
        for g, w in zip(got, want):
            _close(g, w, atol=2e-3, rtol=0)
        kt = arm.fk(s.qpos)
        got = engine._pad_contacts(s, kt, *arm.pinch_velocity(kt, s.qvel))[:5]

        def pads(js):
            kj = jarm.fk(js.qpos)
            return jengine._pad_contacts(js, kj, *jarm.pinch_velocity(kj, js.qvel))

        want = _jv(pads)(js)
        for g, w in zip(got, want):
            _close(g, w, atol=2e-3, rtol=0)


def test_torch_control_step_from_contact_states_matches_jax(jax_control_step):
    for name, s in _contact_states(32).items():
        floor, pad = engine.active_contacts(s)
        assert int((pad if name == "grasp" else floor).sum()) > 0, name
        want = _torch_state(jax_control_step(_jax_state(s)))
        got = engine.control_step(s)
        spread = torch_k1.per_env_errors(got, engine.control_step_plain(torch_k1.to_f64(s)))
        failures, _ = torch_k1.judge(torch_k1.per_env_errors(got, want), spread,
                                     torch_k1.STEP_ATOL, torch_k1.STEP_CAP)
        assert not failures, (name, failures)


def test_torch_kernel_code_on_host_matches_plain():
    """csrc/control_step.cuh built for the CPU against control_step_plain."""
    for name, s in _contact_states(64).items():
        failures, summary, _ = torch_k1.compare_step(torch_k1.host_step, s)
        assert not failures, (name, failures, summary)
        assert summary["max_err"]["qvel"] > 0.0, name  # two codes, not one


def test_torch_kernel_op_count():
    """The operation count behind K1's bound: equal for equal envs, and the
    pad contacts of grasp states cost more than a free gripper."""
    states = _contact_states(4)
    grasp = torch_k1.op_counts(states["grasp"])
    reset = torch_k1.op_counts(torch_k1.reset_states(4, torch.Generator().manual_seed(1), "cpu"))
    assert (reset == reset[0]).all() and reset[0] > 0
    assert (grasp > reset[0]).all()


def test_torch_init_state_matches_jax():
    xy = np.random.default_rng(4).uniform([0.25, -0.25], [0.55, 0.25], (8, 2)).astype(np.float32)
    got = engine.init_state(_t(xy))
    want = _jv(jengine.init_state)(jnp.asarray(xy))
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), atol=1e-7, rtol=0)
        assert getattr(got, f).is_contiguous(), f
    for g, w in zip(engine.observe(got), _jv(jengine.observe)(want)):
        _close(g, w, atol=1e-6, rtol=0)


def test_torch_control_step_100_step_drift_within_bound(jax_control_step):
    n, steps = 32, 100  # 32 envs: the same compiled JAX step as the test above
    rng = np.random.default_rng(5)
    xy = rng.uniform([0.25, -0.25], [0.55, 0.25], (n, 2)).astype(np.float32)
    lo, hi = jpick.CARTESIAN_BOUNDS

    def act(s, a):  # the env's action semantics
        mocap = jnp.clip(s.mocap_pos + a[:3] * jpick.ACTION_SCALE[0], lo, hi)
        grip = jnp.clip(s.grip_ctrl / 255.0 + a[3], 0.0, 1.0) * 255.0
        return s._replace(mocap_pos=mocap, grip_ctrl=grip)

    jax_act, jax_tcp = _jv(act), _jv(lambda s: jengine.observe(s)[0])
    sj = _jv(jengine.init_state)(jnp.asarray(xy))
    st = engine.init_state(_t(xy))
    worst = {"qpos": torch.zeros(n, dtype=torch.float64), "tcp_pos": torch.zeros(n, dtype=torch.float64)}
    for _ in range(steps):
        a = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
        sj = jax_control_step(jax_act(sj, jnp.asarray(a)))
        st = engine.control_step(torch_k1.apply_action(st, _t(a)))
        err = {"qpos": torch_k1.per_env_errors(st, _torch_state(sj))["qpos"],
               "tcp_pos": (engine.observe(st)[0] - _t(jax_tcp(sj))).double().abs().amax(1)}
        worst = {f: torch.maximum(worst[f], err[f]) for f in worst}
    failures, _ = torch_k1.judge(worst, None, torch_k1.DRIFT_ATOL, torch_k1.DRIFT_CAP)
    assert not failures, failures


def test_torch_control_step_wrapper_dispatch():
    s = _contact_states(4)["grasp"]
    before = engine.control_step.launches
    out = engine.control_step(s)  # CPU tensors take the plain version
    assert engine.control_step.launches == before
    for a, b in zip(out, engine.control_step_plain(s)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        engine.control_step(s, obstacles=np.zeros((1, 2, 3), np.float32))
    with pytest.raises(ValueError):
        engine.control_step_cuda(s)  # not on a CUDA card
    with pytest.raises(ValueError):
        engine.control_step_cuda(s._replace(qpos=s.qpos.double()))
    with pytest.raises(ValueError):
        engine.control_step_cuda(s._replace(cube_pos=s.cube_pos.t().contiguous().t()))


def test_torch_kernel_constant_offsets_match_cuda_header():
    """The offsets in csrc/control_step.cuh follow engine's constant table."""
    import re
    from pathlib import Path

    header = Path(engine.__file__).parents[2] / "csrc" / "control_step.cuh"
    text = header.read_text()
    offsets = {"BODY_POS": 0}
    for name, prev, size in re.findall(r"C_(\w+) = C_(\w+) \+ (\d+),", text):
        offsets[name] = offsets[prev] + int(size)
    at = 0
    for name, value in engine._kernel_constant_table():
        assert offsets[name] == at, name
        at += np.asarray(value).size
    assert offsets["COUNT"] == at == engine.kernel_constants().size


@pytest.mark.cuda
def test_torch_control_step_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in (torch_k1.grasp_states(256, g, "cuda"), torch_k1.rollout_states(256, g, "cuda", 5)):
        before = engine.control_step.launches
        engine.control_step(s)
        assert engine.control_step.launches == before + 1
        failures, summary, _ = torch_k1.compare_step(engine.control_step, s)
        assert not failures, (failures, summary)
