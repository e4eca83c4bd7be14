"""The stem levers of `tools/mfu_experiments.py` against the JAX tool's, on
the CPU, at batch 4 x UTD 2 and 32 px: `pad8` (the input's channels
zero-padded to 8) and `s2d` (the first conv as space-to-depth(2) and a 2x2
stride-1 conv), each through tests/torch_mfu.py::variant_parity (the JAX
agent grafted into the port's; the bf16 features, then one update_high_utd
on JAX's draws with float32 convolutions in both packages). The stem's
weights have the lever's shape in both.
"""

import pytest
import torch

from tests.torch_mfu import load_jax_tool, variant_parity

BATCH, UTD, SIZE = 4, 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtool():
    return load_jax_tool("mfu_experiments")


@pytest.mark.parametrize("variant,stem", [("pad8", (32, 8, 3, 3)), ("s2d", (32, 12, 2, 2))])
def test_torch_mfu_stem_lever_matches_the_jax_tool(jtool, monkeypatch, variant, stem):
    from serl_tpu_torch.tools import mfu_experiments as tool

    batch = tool.make_batch(0, 1, 1, SIZE, device="cpu")
    agent = tool.make_agent(variant, batch)
    assert all(tuple(e.convs[0].weight.shape) == stem for e in agent.encoder.encoders.values())
    variant_parity(jtool, monkeypatch, variant, BATCH, UTD, SIZE)
