"""DrQ's "resnet50" encoder (ResNet-v1-50, bottleneck blocks, GroupNorm, under
the learned-embedding head) against the benchmark's plain reference
(`benchmark/reference/drq_resnet50.py`), on the CPU at 32 px.

Seeded random weights, with every GroupNorm scale drawn around 1 (never the
program's zero for a bottleneck block's last norm), so that each residual
branch reaches the map. Compared: the backbone's map and the head's output
(dropout on, the same keep-mask), and the gradient of a weighted sum of the
head's output with respect to every backbone leaf.

Tolerances: the map and the head by their largest gap over the reference's
largest |value|; each leaf's gradient by the norm of its gap over its own
norm, and all leaves' together the same way.
  * float32 convolutions: 2e-5 for the map and the head, 1e-4 for the
    gradients. Both compute the same float32 arithmetic in another order
    (the program's GroupNorm is var_mean + addcmul over the NHWC map, the
    reference torch's group_norm; its "SAME" pads reach the convolution as
    its padding argument where they are even); measured 1.2e-6 (map),
    1.6e-6 (head), 3.5e-6 (worst leaf).
  * the stated bfloat16 convolutions: 0.05 for the map and the head, 0.7
    for a leaf's gradient and 0.35 for all together. Each convolution rounds
    its input, weight and result to bfloat16 (2^-8 relative), forward and
    backward; where the two sides' float32 sums differ in the last bit a
    rounding flips, and 53 convolutions deep those flips grow to about 1% of
    the map (measured 0.93% map, 0.96% head). Backward, each GroupNorm's
    input gradient is a difference of near-equal terms, so the flips grow
    further: measured 0.47 at the worst leaf (the first block's first norm)
    and 0.22 over all leaves, with 4 frames at 32 px (0.41 and 0.18 with 16
    frames; 0.43 and 0.18 at 64 px). A backbone that skips a bottleneck
    block's third convolution, or whose GroupNorm takes 8 groups, fails the
    map's tolerance, and one that does not train has no gradient at all.

The harness's parameter names: `make_image_encoders("resnet50", ...)` builds
one trained ResNet-v1-50 per camera, and every parameter of the agent's
encoders is read by the reference, under the names `cell.make_weights`
writes.

On a card (`-m cuda`, no JAX imported, so `python -m pytest --noconftest`
runs it there): K5 at the head's bottleneck, (M, K, D) = (256, 16,384,
256), forward and backward, under tests/torch_k5.py's rule.
"""

import importlib.util
import os

import pytest
import torch

from benchmark import manifest
from benchmark.reference import drq as drq_ref
from benchmark.reference import drq_resnet50 as ref
from serl_tpu_torch.agents.drq import DrQAgent, make_image_encoders
from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from serl_tpu_torch.vision.encoders import BottleneckResNetBlock, ResNetEncoder

SIZE = 32
FRAMES = 4
CONFIG = manifest.config("drq_resnet50")
STAGES = tuple(CONFIG["encoder"]["stage_sizes"])
WIDTHS = tuple(CONFIG["encoder"]["widths"])
HEAD = ("pool.", "bottleneck.")
# (map, head, a leaf's gradient, all leaves' gradients): see the docstring
TOLERANCES = {torch.float32: (2e-5, 2e-5, 1e-4, 1e-4), torch.bfloat16: (0.05, 0.05, 0.7, 0.35)}


def _encoder(dtype: torch.dtype, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    enc = make_image_encoders("resnet50", ("front",), image_size=SIZE, generator=g)["front"]
    enc.compute_dtype = dtype
    for block in enc.blocks:
        block.compute_dtype = dtype
    with torch.no_grad():
        for n, p in enc.named_parameters():
            if p.dim() == 1 and n.endswith("weight"):  # every norm's scale, none of them 0
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif n.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    img = torch.randint(0, 256, (FRAMES, SIZE, SIZE, 3), generator=g, dtype=torch.uint8)
    mask = torch.rand((FRAMES, enc.dropout_features), generator=g) < drq_ref.DROPOUT_KEEP
    weights = torch.randn((FRAMES, enc.out_features), generator=g)
    return enc, img, mask, weights


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _compare(dtype: torch.dtype):
    """(map, head, {leaf: gradient}) errors of the program against the reference."""
    enc, img, mask, weights = _encoder(dtype)
    prec = ref.Precision(convs="fp32" if dtype == torch.float32 else "bf16")
    params = dict(enc.named_parameters())
    backbone = [n for n in params if not n.startswith(HEAD)]
    with torch.no_grad():
        fmap = enc._backbone(img)
    out = enc(img, train=True, dropout=mask)  # the path the agent's encoder runs
    r_enc = ref.Encoder(CONFIG, "cpu")
    prefixed = {f"e.{n}": p for n, p in params.items()}
    r_map = ref.resnet50_map(img, prefixed, "e", r_enc.stages, r_enc.widths, prec)
    r_out = r_enc.finish(drq_ref.learned_embeddings(r_map, prefixed, "e"), prefixed, "e", mask)
    leaves = [params[n] for n in backbone]
    g_prog = torch.autograd.grad((out * weights).sum(), leaves, allow_unused=True)
    g_ref = torch.autograd.grad((r_out * weights).sum(), leaves)
    grads = {n: (gp, gr) for n, gp, gr in zip(backbone, g_prog, g_ref)}
    return _rel(fmap, r_map.detach()), _rel(out.detach(), r_out.detach()), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_torch_resnet50_encoder_matches_the_reference(dtype):
    map_err, head_err, grads = _compare(dtype)
    map_tol, head_tol, leaf_tol, all_tol = TOLERANCES[dtype]
    assert map_err <= map_tol and head_err <= head_tol, (map_err, head_err)
    assert len(grads) == 3 * 53  # 53 convolutions, each with its norm's scale and bias
    for n, (gp, gr) in grads.items():
        assert gp is not None and gp.norm() > 0 and gr.norm() > 0, n  # every leaf trains
    worst = {n: float((gp - gr).norm() / gr.norm()) for n, (gp, gr) in grads.items()}
    name = max(worst, key=worst.get)
    assert worst[name] <= leaf_tol, (name, worst[name])
    gp, gr = (torch.cat([g[i].flatten() for g in grads.values()]) for i in (0, 1))
    assert float((gp - gr).norm() / gr.norm()) <= all_tol


def test_torch_resnet50_registry_builds_one_trained_resnet50_per_camera():
    keys = tuple(CONFIG["image_keys"])
    encoders = make_image_encoders("resnet50", keys, image_size=SIZE,
                                   generator=torch.Generator().manual_seed(0))
    assert set(encoders) == set(keys) and encoders["front"] is not encoders["wrist"]
    for enc in encoders.values():
        assert isinstance(enc, ResNetEncoder) and not enc.pre_pooling
        assert enc.stage_sizes == STAGES and enc.compute_dtype == torch.bfloat16
        assert all(isinstance(b, BottleneckResNetBlock) for b in enc.blocks)
        widths = [w for w, n in zip(WIDTHS, STAGES) for _ in range(n)]
        assert [b.filters for b in enc.blocks] == widths
        assert enc.feature_shape[-1] == 4 * WIDTHS[-1] == ref.EXPANSION * WIDTHS[-1]
        assert enc.pool.method == "spatial_learned_embeddings"
        assert enc.dropout_features == 4 * WIDTHS[-1] * CONFIG["encoder"]["num_spatial_blocks"]
        assert enc.out_features == CONFIG["encoder"]["bottleneck_dim"]
        assert all(p.requires_grad for p in enc.parameters())


class _Recording(dict):
    """A parameter dict that notes each name the reference reads."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_torch_resnet50_agent_names_are_the_references():
    g = torch.Generator().manual_seed(0)
    keys = tuple(CONFIG["image_keys"])
    obs = {"state": torch.zeros(1, CONFIG["proprio_dim"]),
           **{k: torch.zeros((1, 1, SIZE, SIZE, 3), dtype=torch.uint8) for k in keys}}
    agent = DrQAgent.create_drq(obs, torch.zeros(1, CONFIG["action_dim"]), encoder_type="resnet50",
                                image_keys=keys, generator=g, device="cpu")
    named = dict(agent.named_parameters())
    enc = ref.Encoder(CONFIG, "cpu")
    for key in keys:
        prefix = f"encoder.encoders.{key}"
        mine = {n: p for n, p in named.items() if n.startswith(prefix + ".")}
        params = _Recording({n: p.detach() for n, p in mine.items()})
        x = enc.start(obs[key][:, 0], params, prefix, ref.STATED)
        enc.finish(x, params, prefix, None)
        assert params.read == set(mine)  # every trained tensor, and nothing else
    critic = {id(p) for p in agent.state.params["critic"]}
    assert all(id(p) in critic for n, p in named.items() if n.startswith("encoder.encoders."))


@pytest.mark.cuda
def test_torch_resnet50_head_bottleneck_k5_on_card():
    """K5 at the head's bottleneck, (1, 256, 16,384, 256), forward and
    backward, against the plain versions under tests/torch_k5.py's rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    # by its path: the card's machine may hold another package named "tests"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_k5.py")
    spec = importlib.util.spec_from_file_location("torch_k5", path)
    torch_k5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_k5)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(23)
    k = 4 * WIDTHS[-1] * CONFIG["encoder"]["num_spatial_blocks"]
    x, kernel, bias, gamma, beta, dy = torch_k5.inputs("linear", 1, 256, k, 256, g, "cuda")
    x3, w3, b2, _ = k5.member_views(x, kernel, bias, False)
    out = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
    assert not torch_k5.failures(*torch_k5.forward_errors(x3, w3, b2, gamma, beta, *out))
    py, ph, pmean, prstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
    grads = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
    assert not torch_k5.failures(*torch_k5.backward_errors(dy, py, ph, pmean, prstd, gamma, *grads))
