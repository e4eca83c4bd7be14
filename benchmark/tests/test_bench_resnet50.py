"""`resnet50.learn` at a tiny size on the CPU, and `drq_resnet50`'s count.

The harness drives the cell end to end (`run_tiny`, 32 px): the sound run is
`correct` under the cell's limits; the control (float8 convolutions, TF32
products) and the planted `half_batch` and `unchanged_state` faults are not.

The count (`flops/drq_resnet50.py`) lists one frame's convolutions as the
program's backbone runs them, at 32 and at 128 px (each convolution's
multiply-adds, from the shapes that reach `aten.convolution`, recorded on
meta tensors); and its update and policy pass equal FlopCounterMode over
the plain reference's, at 64 px (at 32 px the map is 1 x 1, and the head's
einsum is a product that FlopCounterMode does not count).
"""

import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check, manifest
from benchmark.counting import total_flops
from benchmark.reference import drq
from benchmark.tests.helpers import run_tiny
from benchmark.tests.test_bench_faults import FAULTS
from benchmark.tests.test_bench_flops import SMALL, _inputs

CELL = "resnet50.learn"
CONFIG = "drq_resnet50"


@pytest.mark.parametrize("mode", ["program", "control", "half_batch", "unchanged_state"])
def test_resnet50_cell_tiny(mode, monkeypatch):
    if mode in FAULTS:
        FAULTS[mode](monkeypatch)
    result = run_tiny(CELL, mode="control" if mode == "control" else "program")
    assert result["correct"] == (mode == "program"), result["checks"]


class _Convolutions(TorchDispatchMode):
    """Each convolution's multiply-adds a frame, in the order they run."""

    def __init__(self):
        super().__init__()
        self.macs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            # (1, out, h, w) from an (out, in, kh, kw) kernel
            self.macs.append(math.prod(out.shape[1:]) * math.prod(args[1].shape[1:]))
        return out


@pytest.mark.parametrize("size", [32, 128])
def test_resnet50_count_lists_the_programs_convolutions(size):
    from serl_tpu_torch.agents.drq import make_image_encoders

    config = {**manifest.config(CONFIG), "image_size": size}
    enc = make_image_encoders(config["encoder_type"], ("front",), image_size=size,
                              generator=torch.Generator().manual_seed(0))["front"].to("meta")
    img = torch.empty((1, size, size, 3), dtype=torch.uint8, device="meta")
    with _Convolutions() as seen:
        enc._backbone(img)
    layers, (side, channels) = manifest.flops(CONFIG).layers(config)
    assert seen.macs == [macs for _, macs in layers]
    assert len(layers) == 53 and (side, channels) == tuple(enc.feature_shape[1:])
    assert enc.feature_shape[0] == side
    names = {n.rsplit(".weight", 1)[0] for n, p in enc.named_parameters()
             if p.dim() == 4 and not n.startswith("pool.")}
    assert names == {n for n, _ in layers}  # one entry for each convolution's kernel


def test_resnet50_count_equals_flop_counter_over_the_reference():
    from serl_tpu_torch.training.launcher import make_drq_agent

    config = {**manifest.config(CONFIG), "image_size": 64}
    traffic = {**manifest.traffic("learn"), **SMALL}
    g = torch.Generator().manual_seed(0)
    batch, obs = _inputs(config, traffic, g)
    keys = tuple(config["image_keys"])
    agent = make_drq_agent(0, {k: v[:1] for k, v in obs.items()},
                           torch.zeros(1, config["action_dim"]), image_keys=keys,
                           encoder_type=config["encoder_type"], device="cpu")
    params = {n: p.detach() for n, p in agent.named_parameters()}
    draws = agent.drq_draws(batch, traffic["utd_ratio"], generator=g)
    learner = check.make_learner(config, params, "cpu")
    prec = check.precision(config)
    calls = manifest.flops(CONFIG).calls(config, traffic)
    with FlopCounterMode(display=False) as counter:
        drq.update_high_utd(learner, batch, draws, traffic["utd_ratio"], prec)
    assert total_flops(calls["update"]) == counter.get_total_flops()
    eps = torch.randn(traffic["num_envs"], config["action_dim"], generator=g)
    with FlopCounterMode(display=False) as counter:
        drq.act(learner, obs, eps, prec)
    assert total_flops(calls["policy"]) == counter.get_total_flops()
    assert total_flops(calls["iteration"]) == (total_flops(calls["policy"])
                                               + 2 * total_flops(calls["update"]))
