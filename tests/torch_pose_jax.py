"""Shared helpers of the pose-task parity tests: port states to JAX states,
JAX's reset draws replayed for the port, and the per-env physics rule.

`jax_reset_draws` replays the key splits of
`serl_tpu/envs/tasks.py::PandaPoseTaskEnv._reset_state` (and the pick env's
`reset` inside it, and `_maybe_demo_reset`) so that the port's reset takes
the very numbers JAX's draws from the same key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs.panda_pick import EnvState
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.envs.physics.arm import fk
from serl_tpu_torch.envs.tasks import PandaPoseTaskEnv, ResetDraws
from tests import torch_k1

# two float32 angles are compared modulo 2 pi: roll sits at the +-pi flip
ANGLE_ATOL = 1e-5


def to_jax(state: EnvState, rng=None) -> jpick.EnvState:
    """A port EnvState as a batched JAX EnvState (rng: (N, 2) keys)."""
    n = state.t.shape[0]
    return jpick.EnvState(
        physics=jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in state.physics)),
        t=jnp.asarray(state.t.numpy()),
        z_init=jnp.asarray(state.z_init.numpy()),
        rng=jax.random.split(jax.random.PRNGKey(0), n) if rng is None else rng,
        ep_id=jnp.asarray(state.ep_id.numpy()),
    )


def to_torch(state: jpick.EnvState) -> EnvState:
    t = lambda x: torch.from_numpy(np.array(x))
    return EnvState(engine.PhysicsState(*map(t, state.physics)), t(state.t), t(state.z_init),
                    t(state.ep_id))


def jax_reset_draws(keys, config, bank_size=None) -> ResetDraws:
    """The draws JAX's `_reset_state(key)` takes, per key of (N, 2) keys."""
    lo, hi = jpick.SAMPLING_BOUNDS

    def one(key):
        rng, k_xy, k_rz, _ = jax.random.split(key, 4)
        _, k_block, _ = jax.random.split(rng, 3)  # the pick env's reset(rng)
        xy = jax.random.uniform(k_block, (2,), minval=lo, maxval=hi)
        r, rz = config.random_xy_range, config.random_rz_range
        dxy = jax.random.uniform(k_xy, (2,), minval=-r, maxval=r)
        drz = jax.random.uniform(k_rz, (), minval=-rz, maxval=rz)
        k_sel, k_idx = jax.random.split(jax.random.fold_in(rng, 7))  # _maybe_demo_reset
        return xy, dxy, drz, jax.random.uniform(k_sel), jax.random.randint(
            k_idx, (), 0, bank_size or 1)

    xy, dxy, drz, use, idx = (torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys))
    if not bank_size:
        return ResetDraws(xy, dxy, drz)
    return ResetDraws(xy, dxy, drz, use, idx.long())


def angle_error(got, want) -> np.ndarray:
    """|got - want| modulo 2 pi, elementwise."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return np.abs((d + np.pi) % (2 * np.pi) - np.pi)


def assert_angles_close(got, want, atol=ANGLE_ATOL, err_msg=""):
    """Angles equal modulo 2 pi."""
    d = angle_error(got, want)
    assert d.max() <= atol, f"{err_msg}: angles differ by {d.max():.3g} (mod 2 pi) > {atol}"


def assert_pose_close(got, want, qpos, atol=ANGLE_ATOL, err_msg=""):
    """(N, 6) tcp poses of the joint angles `qpos`: positions to atol, Euler
    angles modulo 2 pi to atol plus 3x the port's own float32-vs-float64
    spread there. Near the 180-degree orientation mat_to_quat takes small
    components from square roots of rounding-sized differences, which turns
    float32 rounding into Euler errors of up to ~5e-5 at some joint angles
    (the discontinuity tests/torch_k1.py describes)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=atol, rtol=0, err_msg=err_msg)
    pose = lambda q: PandaPoseTaskEnv._pose(fk(q)).numpy()
    spread = angle_error(pose(qpos.float())[:, 3:], pose(qpos.double())[:, 3:])
    excess = angle_error(got[:, 3:], want[:, 3:]) - (atol + 3.0 * spread)
    assert excess.max() <= 0, (f"{err_msg}: Euler angles differ by up to {excess.max():.3g} "
                               f"beyond {atol} + 3 x the float32 spread (mod 2 pi)")


def assert_physics_close(got, want, exact):
    """The per-env rule of tests/torch_k1.py, no env excepted beyond its
    budget: `got` the port's float32 physics, `want` JAX's, `exact` the
    port's float64 run of the same control steps from the same state."""
    want = engine.PhysicsState(*(torch.from_numpy(np.array(x)) for x in want))
    atol = {f: max(a, 1e-6 if f == "mocap_pos" else 1e-4 if f == "grip_ctrl" else 0.0)
            for f, a in torch_k1.STEP_ATOL.items()}
    cap = {f: max(a, atol[f]) for f, a in torch_k1.STEP_CAP.items()}
    # the mocap quaternion comes from float32 trig in both frameworks
    atol["mocap_quat"] = cap["mocap_quat"] = 2e-6
    failures, _ = torch_k1.judge(torch_k1.per_env_errors(got, want),
                                 torch_k1.per_env_errors(got, exact), atol, cap)
    assert not failures, failures
