"""One encoder for both cameras in `tools/mfu_experiments.py` against the
JAX tool's, on the CPU, at batch 4 x UTD 2 and 32 px: `shared` (the
cameras stacked on the batch axis through it, the ObsEncoder's batch
concat) and `shared` with `no_concat` (applied per camera), each through
tests/torch_mfu.py::variant_parity. The shared encoder trains: its weights
move in the update, and the critic group holds them once.
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


@pytest.mark.parametrize("no_concat", [False, True])
def test_torch_mfu_shared_encoder_matches_the_jax_tool(jtool, monkeypatch, no_concat):
    variant_parity(jtool, monkeypatch, "baseline", BATCH, UTD, SIZE, shared=True,
                   no_concat=no_concat)


@pytest.mark.parametrize("no_concat", [False, True])
def test_torch_shared_encoder_trains(no_concat):
    """A module that serves both cameras keeps its own parameters through
    the target critic's pass (which swaps the target's in and back) and
    moves with the critic's gradient."""
    from serl_tpu_torch.tools import mfu_experiments as tool

    batch = tool.make_batch(0, 4, 2, SIZE, device="cpu")
    agent = tool.make_agent("baseline", batch, shared=True, no_concat=no_concat)
    opt = {"learning_rate": 1e-3}
    agent.init_train_state(opt, opt, opt)
    enc = agent.encoder.encoders["front"]
    assert enc is agent.encoder.encoders["wrist"]
    params = list(enc.parameters())
    assert len(agent.state.params["critic"]) == len(params) + 4 + len(
        list(agent.critic.parameters()))
    before = [p.detach().clone() for p in params]
    agent.update_high_utd(batch, utd_ratio=2, generator=torch.Generator().manual_seed(0))
    assert all(p is q for p, q in zip(enc.parameters(), params))
    assert all(not torch.equal(p, b) for p, b in zip(enc.parameters(), before))
    assert all(p is q for p, q in zip(agent.state.params["critic"], params))
