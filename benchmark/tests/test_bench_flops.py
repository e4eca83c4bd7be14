"""The count that `mfu` and the K5 roofline take their numerators from
equals FlopCounterMode over the plain reference's update and policy pass."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check, manifest
from benchmark.counting import total_flops
from benchmark.reference import drq
from benchmark.tests.helpers import reference_params, update_draws

SMALL = dict(num_envs=3, batch_size=4, utd_ratio=2, updates_per_iter=2)


def _inputs(config, traffic, g):
    rows, n = traffic["batch_size"] * traffic["utd_ratio"], traffic["num_envs"]
    size = config["image_size"]

    def obs(r):
        return {"state": torch.randn(r, config["proprio_dim"], generator=g),
                **{k: torch.randint(0, 256, (r, 1, size, size, 3), generator=g, dtype=torch.uint8)
                   for k in config["image_keys"]}}

    batch = {"observations": obs(rows), "next_observations": obs(rows),
             "actions": torch.rand(rows, config["action_dim"], generator=g) * 2 - 1,
             "rewards": torch.rand(rows, generator=g), "masks": torch.ones(rows),
             "dones": torch.zeros(rows)}
    return batch, obs(n)


# at 64 px the ResNet's map is 2 x 2: a 1 x 1 map makes the head's einsum a
# product that FlopCounterMode does not count
@pytest.mark.parametrize("name, size", [("drq_small", 32), ("drq_resnet10", 64)])
def test_count_equals_flop_counter_over_the_reference(name, size):
    config = {**manifest.config(name), "image_size": size}
    traffic = {**manifest.traffic("learn"), **SMALL}
    g = torch.Generator().manual_seed(0)
    params = reference_params(config, g)
    learner = check.make_learner(config, params, "cpu")
    prec = check.precision(config)
    batch, obs = _inputs(config, traffic, g)
    draws = update_draws(config, traffic, g, "cpu")
    calls = manifest.flops(name).calls(config, traffic)
    with FlopCounterMode(display=False) as counter:
        drq.update_high_utd(learner, batch, draws, traffic["utd_ratio"], prec)
    assert total_flops(calls["update"]) == counter.get_total_flops()
    eps = torch.randn(traffic["num_envs"], config["action_dim"], generator=g)
    with FlopCounterMode(display=False) as counter:
        drq.act(learner, obs, eps, prec)
    assert total_flops(calls["policy"]) == counter.get_total_flops()
    assert total_flops(calls["iteration"]) == (total_flops(calls["policy"])
                                               + 2 * total_flops(calls["update"]))
    off = manifest.flops(name).calls(config, {**traffic, "learner": False})
    assert total_flops(off["iteration"]) == total_flops(calls["policy"])  # the policy pass alone
