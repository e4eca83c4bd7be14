"""Each configuration's reference is its own file, found by its name, and the
shared reference follows a tiny seeded case as it did before the encoders
moved out of `reference/drq.py`: `follow_recorded.json` holds the losses,
the norm of every first-gradient and parameter leaf, and the actions that
the harness gave on this case when the encoders were still inside it."""

import json
import os

import pytest
import torch

from benchmark import check, manifest
from benchmark.tests.helpers import reference_params, update_draws

RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "follow_recorded.json")
CASES = (("drq_small", 32), ("drq_resnet10", 64))  # at 64 px the ResNet's map is 2 x 2


def test_every_configuration_resolves_to_its_own_reference():
    for entry in manifest.benchmark()["configs"]:
        ref = manifest.reference(entry["name"])
        assert ref.__file__ == os.path.join(manifest.HERE, "reference", f"{entry['name']}.py")
        assert ref.STATED != ref.CONTROL and hasattr(ref.STATED, "tf32_products")
        for method in ("start", "finish", "frozen_map"):
            assert hasattr(ref.Encoder, method)


def _case(name, size):
    """Seeded weights, two checked calls of random batches and their draws,
    and a policy call, at a tiny size."""
    config = {**manifest.config(name), "image_size": size}
    traffic = {**manifest.traffic("learn"), "num_envs": 3, "batch_size": 4, "utd_ratio": 2}
    g = torch.Generator().manual_seed(7)
    initial = reference_params(config, g)

    def obs(rows):
        return {"state": torch.randn(rows, config["proprio_dim"], generator=g),
                **{k: torch.randint(0, 256, (rows, 1, size, size, 3), generator=g, dtype=torch.uint8)
                   for k in config["image_keys"]}}

    calls = []
    for _ in range(2):
        batch = {"observations": obs(8), "next_observations": obs(8),
                 "actions": torch.rand(8, 4, generator=g) * 2 - 1,
                 "rewards": torch.rand(8, generator=g), "masks": torch.ones(8),
                 "dones": torch.zeros(8)}
        calls.append({"batch": batch, "draws": update_draws(config, traffic, g, "cpu")})
    policy = {"obs": obs(3), "noise": torch.randn(3, 4, generator=g), "after_calls": 1}
    return config, traffic, initial, calls, policy


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in sorted(tree.items())}


@pytest.mark.parametrize("name, size", CASES)
@pytest.mark.parametrize("after_calls", (0, 1))
def test_follow_gives_what_it_gave_before(name, size, after_calls):
    with open(RECORDED) as f:
        want = json.load(f)[f"{name}.after{after_calls}"]
    config, traffic, initial, calls, policy = _case(name, size)
    losses, grads, params, actions = check.follow(config, traffic, initial, calls,
                                                  {**policy, "after_calls": after_calls}, "cpu")
    close = dict(rel=1e-6, abs=1e-9)
    assert losses == [pytest.approx(w, **close) for w in want["losses"]]
    assert _norms(grads) == pytest.approx(want["grads"], **close)
    assert _norms(params) == pytest.approx(want["params"], **close)
    assert actions.double().flatten().tolist() == pytest.approx(want["actions"], **close)
