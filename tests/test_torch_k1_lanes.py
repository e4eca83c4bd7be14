"""K1's cooperative code (serl_tpu_torch/csrc/control_step.cuh) built for the CPU.

The header runs an env's control step as phases of a lane group; the host
build (tests/k1_host.cpp, through tests/torch_k1.py) runs each phase's lanes
as a loop, in descending or in ascending order, with every intermediate made
NaN as a substep starts. These tests hold that code:
  * its operation count, which gives K1's bound, against the one-thread-per-
    env design it replaced, on the same states: within 5% per env (the
    cooperative code counts each value once, a value that several lanes
    compute alike on one lane only), and its critical path below the total;
  * the two lane orders against each other, bit for bit (no task reads what
    another task of its phase writes), and against control_step_plain under
    the per-env rule of tests/torch_k1.py;
  * its division by a reciprocal against IEEE division, bit for bit;
  * planted faults in a copy of the header: each must fail that rule, or give
    NaN, in at least one lane order.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tests import torch_k1

# Operations per env of one control step in the one-thread-per-env kernel
# code that this design replaced, counted by the same host build on the same
# states (every env of each set counts alike).
PARENT_OPS = {"reset": 85314, "grasp": 87350}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _count_states(name):
    if name == "reset":
        return torch_k1.reset_states(4, torch.Generator().manual_seed(1), "cpu")
    return torch_k1.grasp_states(4, torch.Generator().manual_seed(0), "cpu")


def _contact_states(n=32):
    g = torch.Generator().manual_seed(0)
    return {"grasp": torch_k1.grasp_states(n, g, "cpu"),
            "rollout": torch_k1.rollout_states(n, g, "cpu", steps=3)}


@pytest.mark.parametrize("name", sorted(PARENT_OPS))
def test_torch_k1_op_count_within_5_percent_of_parent(name):
    ops, path = torch_k1.op_and_path_counts(_count_states(name))
    assert (np.abs(ops / PARENT_OPS[name] - 1.0) <= 0.05).all(), (name, ops)
    assert ((path > 0) & (path < ops)).all(), (name, path, ops)


def test_torch_k1_host_lane_orders_agree_and_match_plain():
    for name, s in _contact_states().items():
        down = torch_k1.host_step(s)
        up = torch_k1.host_step(s, ascending=True)
        for f, a, b in zip(down._fields, down, up):
            assert torch.equal(a, b), (name, f)
        failures, summary, _ = torch_k1.compare_step(
            lambda x: torch_k1.host_step(x, ascending=True), s)
        assert not failures, (name, failures, summary)


def test_torch_k1_division_by_reciprocal_equals_ieee_division():
    """div_rcp, the kernel's division by a reciprocal with Markstein's
    correction, against x / d bit for bit (zero dividends and their signs
    included), with the reciprocal of d and with 1 / sqrt(p) for d = sqrt(p)."""
    assert torch_k1.div_mismatches(2_000_000) == 0


# (anchor in control_step.cuh, replacement): each plants one fault
PLANTED_FAULTS = {
    # the floor forces summed without corner 0, one of the four bottom
    # corners that carry a resting cube
    "floor_corner_dropped": [(
        "for (int k = 0; k < 8; ++k) sum = sum + g.corner[k][d];",
        "for (int k = 1; k < 8; ++k) sum = sum + g.corner[k][d];")],
    # the cube's rotational right-hand side formed one phase early, in the
    # phase whose other lanes write the pad torques that it reads
    "cube_rhs_one_phase_early": [
        ("      g.pad_sum[q] = sum;\n",
         "      g.pad_sum[q] = sum;\n"
         "      if (q < 3) g.rhs3[q] = (g.floor_sum[3 + q] + g.pad_sum[3 + q]) - g.gyro[q];\n"),
        ("      g.rhs3[d] = (g.floor_sum[3 + d] + g.pad_sum[3 + d]) - g.gyro[d];\n", "")],
}


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_torch_k1_host_check_catches_planted_fault(fault, tmp_path):
    header = os.path.join(torch_k1.CSRC, "control_step.cuh")
    with open(header) as f:
        text = f.read()
    for anchor, replacement in PLANTED_FAULTS[fault]:
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, replacement)
    csrc = str(tmp_path)
    with open(os.path.join(csrc, "control_step.cuh"), "w") as f:
        f.write(text)
    caught = []
    for ascending in (False, True):
        for name, s in _contact_states(16).items():
            failures, _, _ = torch_k1.compare_step(
                lambda x: torch_k1.host_step(x, csrc=csrc, ascending=ascending), s)
            caught.append(bool(failures))
    shutil.rmtree(csrc)
    assert any(caught), fault
