"""The port's `tools/mfu_experiments.py` against the JAX package's, on the
CPU, at batch 4 x UTD 2 and 32 px (the tools' full widths otherwise).

- `make_batch`: the JAX tool's keys, shapes and dtypes.
- Each lever (tests/torch_mfu.py::variant_parity): the JAX tool's agent
  grafted into the port's; the encoder features at the lever's compute
  dtype, then one update_high_utd on JAX's draws, every loss within
  tests/test_torch_drq.py's tolerances. `pad8` and `s2d` are in
  test_torch_mfu_stem_tool.py, the shared encoder in
  test_torch_mfu_shared_tool.py (the JAX update's compile, ~20 s a lever on
  one core, is most of each).
- K5's FLOP tally: `product_flops` of a call's shape equals
  FlopCounterMode's count of the plain version's product, in each input
  form of `member_views`.
- `main` end to end with `--device cpu` at a tiny size.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from serl_tpu_torch.tools import mfu_experiments as tool
from tests.torch_mfu import load_jax_tool, variant_parity

BATCH, UTD, SIZE = 4, 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtool():
    return load_jax_tool("mfu_experiments")


def test_torch_make_batch_matches_the_jax_tool(jtool):
    want = jtool.make_batch(0, BATCH, UTD, size=SIZE)
    got = tool.make_batch(0, BATCH, UTD, size=SIZE, device="cpu")
    flat = lambda tree: {"/".join(str(getattr(p, "key", p)) for p in path): leaf
                         for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
    n = BATCH * UTD
    assert got["observations/front"].shape == (n, 1, SIZE, SIZE, 3)
    assert int(got["observations/front"].max()) <= 254
    again = tool.make_batch(0, BATCH, UTD, size=SIZE, device="cpu")
    assert torch.equal(again["observations"]["wrist"], got["observations/wrist"])


@pytest.mark.parametrize("variant", ["baseline", "f32", "half_aug"])
def test_torch_mfu_variant_matches_the_jax_tool(jtool, monkeypatch, variant):
    variant_parity(jtool, monkeypatch, variant, BATCH, UTD, SIZE)


@pytest.mark.parametrize("form", ["linear", "shared", "member"])
def test_torch_k5_flop_tally_equals_the_plain_product_count(form):
    """The forward kernel's tally (`product_flops` of the call's shape, added
    where the kernel launches) is what FlopCounterMode counts in the plain
    version's product, in each input form; a whole CPU call through the
    autograd Function counts the same, and adds nothing to the tally."""
    g = torch.Generator().manual_seed(0)
    e, rows, kdim, d = 3, 5, 14, 64
    x = torch.randn((e, rows, kdim) if form == "member" else (rows, kdim), generator=g)
    kernel = torch.randn((d, kdim) if form == "linear" else (e, kdim, d), generator=g)
    bias = torch.randn((d,) if form == "linear" else (e, d), generator=g)
    gamma, beta = torch.randn(d, generator=g), torch.randn(d, generator=g)
    member = form == "member"
    shape = k5.call_shape(x, kernel, member)
    assert shape[0] == form
    x3, w3, b2, _ = k5.member_views(x, kernel, bias, member)
    counter = FlopCounterMode(display=False)
    with counter:
        k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
    want = k5.product_flops(shape)
    assert want == 2 * math.prod(shape[1:5])
    assert counter.get_total_flops() == want
    k5.flops = 0
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            k5.dense_layer_norm_tanh(x, kernel, bias, gamma, beta, member_inputs=member)
        assert counter.get_total_flops() == want and k5.flops == 0
    finally:
        k5.flops = None


def test_torch_mfu_main_runs_on_cpu(capsys):
    results = tool.main(["--device", "cpu", "--batch", "2", "--utd", "2", "--size", "32",
                         "--iters", "1"])
    assert list(results) == list(tool.VARIANTS)
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    out = capsys.readouterr().out
    assert "baseline: " in out and "(1.00x baseline)" in out
