"""K1's obstacle input (the bin walls) against serl_tpu, on the CPU.

- The plain twin `control_step_plain(state, walls)` against JAX's
  `control_step(state, walls)` under tests/torch_k1.py's per-env rule (the
  port's float64 run as the measure of rounding), at states where cube
  corners sit inside a wall (pressed in, in a bin's corner, on a wall's
  top, at a wall's top edge) and at exact ties: a corner equally deep along
  two axes (the first axis wins), a corner midway between an axis' two
  faces (the push goes along +axis), and a corner exactly on a face (not
  inside: the test is strict). Every set has active obstacle contacts.
- csrc/control_step.cuh with the wall table, built for the CPU
  (tests/k1_host.cpp): both lane orders equal bit for bit and within the
  rule of the plain twin; a table of M = 0 equal bit for bit to no table and
  to the header built with its obstacle code compiled out
  (SERL_NO_OBSTACLES); its operation count (K1's bound) with the walls;
  faults planted in a copy of the header (the tie rule, the strict test,
  the sign at a tie) fail the rule.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs.physics import engine as jengine
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.envs.physics import engine
from tests import torch_k1
from tests.torch_pose_jax import assert_physics_close

WALLS = torch.as_tensor(tasks.bin_walls())
N = 24
HALF = float(engine.CUBE_HALF[0])
# exact-tie boxes, all edges dyadic, apart in y (one per case of
# tie_states): an x/z tie box, a box narrow in x whose two x faces are
# equally far from x = 0.5, a box whose lo x face is x = 0.5
TIE_BOXES = np.asarray([
    [[0.25, -1.0, 0.25], [0.5, -0.5, 0.5]],
    [[0.4921875, -0.25, 0.0], [0.5078125, 0.25, 1.0]],
    [[0.5, 0.5, 0.0], [0.75, 1.0, 1.0]],
], np.float32)
CASE_Y = (-0.75, 0.0, 0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(jax.vmap(jengine.control_step, in_axes=(0, None)))


def _below(target: float) -> np.float32:
    """A float32 centre c with fl32(c + HALF) == target exactly."""
    c = np.float32(target - HALF)
    while np.float32(c + np.float32(HALF)) > np.float32(target):
        c = np.nextafter(c, np.float32(-1))
    while np.float32(c + np.float32(HALF)) < np.float32(target):
        c = np.nextafter(c, np.float32(1))
    assert np.float32(c + np.float32(HALF)) == np.float32(target)
    return c


def tie_states(n: int, g: torch.Generator):
    """Axis-aligned cubes over TIE_BOXES (each env one case, in turn): a
    corner column 1 mm inside the x/z tie box's top x edge at equal x and z
    depths; a corner column exactly at x = 0.5 inside the narrow box; a
    corner column exactly on the third box's lo x face, moving into it."""
    s = torch_k1.reset_states(n, g, "cpu")
    case = torch.arange(n) % 3
    c_tie = float(_below(0.499))  # x and z alike: fl32(c + HALF) = 0.499 on both axes
    c_mid = float(_below(0.5))
    pos = torch.stack([
        torch.where(case == 0, c_tie, c_mid),
        torch.tensor(CASE_Y)[case] + 0.1 * (2.0 * torch.rand(n, generator=g) - 1.0),
        torch.where(case == 0, c_tie, 0.25),
    ], -1).float()
    vel = torch.where((case == 2)[:, None], torch.tensor([0.5, 0.0, 0.0]),
                      0.02 * (2.0 * torch.rand((n, 3), generator=g) - 1.0))
    return s._replace(cube_pos=pos.contiguous(),
                      cube_quat=torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(n, 1),
                      cube_linvel=vel.float().contiguous(), cube_angvel=torch.zeros(n, 3))


def _sets():
    g = torch.Generator().manual_seed(0)
    sets = {kind: (s, WALLS) for kind, s in torch_k1.bin_states(N, g, "cpu").items()}
    sets["ties"] = (tie_states(N, g), torch.as_tensor(TIE_BOXES))
    return sets


SETS = _sets()


def test_torch_bin_walls_equal_jax():
    env = jtasks.BinRelocationEnv(task_id=0)
    np.testing.assert_array_equal(tasks.bin_walls(), np.asarray(env.obstacles))


@pytest.mark.parametrize("kind", sorted(SETS))
def test_torch_control_step_with_walls_matches_jax(kind, jax_step):
    s, boxes = SETS[kind]
    active = engine.active_obstacle_contacts(s, boxes)
    assert int(active.any(-1).any(-1).sum()) >= N // 2, f"{kind}: too few envs in contact"
    got = engine.control_step(s, boxes)
    want = jax_step(jengine.PhysicsState(*(jnp.asarray(x.numpy()) for x in s)),
                    jnp.asarray(boxes.numpy()))
    exact = engine.control_step_plain(torch_k1.to_f64(s), boxes)
    assert_physics_close(got, want, exact)
    # the walls matter: without them the step differs
    free = engine.control_step_plain(s)
    assert (got.cube_linvel - free.cube_linvel).abs().max() > 1e-3


def test_torch_tie_states_are_ties():
    s, boxes = SETS["ties"]
    active = engine.active_obstacle_contacts(s, boxes)
    case = torch.arange(N) % 3
    # x/z tie and the midway corner are inside; a corner on a face is not
    assert active[case == 0].any(-1).any(-1).all() and active[case == 1].any(-1).any(-1).all()
    assert not active[case == 2].any()


@pytest.mark.parametrize("kind", sorted(SETS))
def test_torch_kernel_code_with_walls_on_host(kind):
    s, boxes = SETS[kind]
    down, up = torch_k1.host_step(s, boxes), torch_k1.host_step(s, boxes, ascending=True)
    assert all(torch.equal(a, b) for a, b in zip(down, up)), "the lane orders disagree"
    failures, summary, _ = torch_k1.compare_step(torch_k1.host_step, s, boxes)
    assert not failures, (kind, failures, summary)


def test_torch_kernel_code_without_obstacles_is_unchanged():
    """M = 0, no table and the header with its obstacle code compiled out
    give the same bits."""
    s = SETS["corner"][0]
    base = torch_k1.host_step(s, no_obstacles=True)
    for got in (torch_k1.host_step(s), torch_k1.host_step(s, WALLS[:0])):
        assert all(torch.equal(a, b) for a, b in zip(got, base))
    assert all(torch.equal(a, b) for a, b in zip(engine.control_step_plain(s, WALLS[:0]),
                                                 engine.control_step_plain(s)))


def test_torch_kernel_op_count_with_walls():
    """K1's bound with the walls: a state touching no wall adds exactly the
    corner-vs-box subtractions (10 substeps x 8 corners x 8 boxes x 6); an
    empty table adds nothing; a state in contact adds more."""
    free = torch_k1.reset_states(4, torch.Generator().manual_seed(1), "cpu")
    free = free._replace(cube_pos=torch.tensor([[0.3, 0.0, HALF]]).repeat(4, 1))  # between the bins
    assert not engine.active_obstacle_contacts(free, WALLS).any()
    base = torch_k1.op_counts(free)
    np.testing.assert_array_equal(torch_k1.op_counts(free, WALLS[:0]), base)
    np.testing.assert_array_equal(torch_k1.op_counts(free, WALLS) - base, 10 * 8 * 8 * 6)
    s = SETS["corner"][0]
    extra = torch_k1.op_counts(s, WALLS) - torch_k1.op_counts(s)
    assert (extra > 10 * 8 * 8 * 6).all()


FAULTS = {
    "a tie picks the later axis": ("(depth_axis[2] < depth_axis[0] ? 2 : 0)",
                                   "(depth_axis[2] <= depth_axis[0] ? 2 : 0)"),
    "inside is not strict": ("inside = inside && d_lo > 0.0f && d_hi > 0.0f;",
                             "inside = inside && d_lo >= 0.0f && d_hi >= 0.0f;"),
    "a sign tie pushes along -axis": ("sign[d] = d_lo < d_hi ? -1.0f : 1.0f;",
                                      "sign[d] = d_lo <= d_hi ? -1.0f : 1.0f;"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_torch_planted_obstacle_fault_fails(fault, tmp_path):
    old, new = FAULTS[fault]
    csrc = tmp_path / "csrc"
    shutil.copytree(torch_k1.CSRC, csrc)
    header = csrc / "control_step.cuh"
    text = header.read_text()
    assert old in text, fault
    header.write_text(text.replace(old, new))
    s, boxes = SETS["ties"]
    failures, _, _ = torch_k1.compare_step(
        lambda x, b: torch_k1.host_step(x, b, csrc=os.fspath(csrc)), s, boxes)
    assert failures, f"the planted fault ({fault}) passed"
