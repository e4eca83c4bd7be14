"""MobileNetV1, its TF-slim import and the frozen-backbone encoder against
serl_tpu, on the CPU.

No ImageNet checkpoint is in the repository: the weights are a synthetic
dict in TF-slim's names and shapes, made from a seed
(tests/test_mobilenet_v1.py's `synthetic_tf_slim_ckpt`), rescaled so that
the image's signal survives 27 layers (He-scaled kernels, BatchNorms near
the identity): with the raw draws the folded biases dominate and the final
map hardly depends on the image, so a fault near the input could hide.

- `load_tf_slim_params` equals JAX's exactly (numpy copies and the same
  float32 folding), from a dict with and without the `MobilenetV1/`
  prefix, an .npz and a pickle.
- MobileNetV1 at width 0.25 on 32 and 40 px images (40: odd maps, where
  flax's "SAME" pads differ from symmetric ones): within 1e-4 abs of flax's
  (27 convolutions of up to 256 channels, taken in another order).
- The frozen-backbone encoder in train mode (learned-embedding pooling with
  flax's dropout mask, the bottleneck): 1e-4 abs.
- One `update_high_utd` (UTD 2, batch 4) of a SAC agent through the frozen
  MobileNet encoder, the dropout keep-mask of every encoder pass recorded
  from flax's jitted run (tests/test_torch_gc_sac.py's `update_parity`): the learner
  state within 2e-6 abs; the backbone bit for bit unchanged, holding no
  optimizer state and taking no gradient.
The planted fault this file catches: the depthwise kernels left in TF-slim's
(H, W, C, 1) layout (the loader against JAX's, and the shapes the port's
module checks).
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from serl_tpu.vision.mobilenet import FrozenBackboneEncoder as JaxFrozenBackboneEncoder
from serl_tpu.vision.mobilenet_v1 import MobileNetV1 as JaxMobileNetV1
from serl_tpu.vision.mobilenet_v1 import load_tf_slim_params as jax_load
from serl_tpu.vision.mobilenet_v1 import make_mobilenet_encoder as jax_make_encoder
from serl_tpu_torch.utils.jax_params import _head_pairs, load_pairs, pairs_to_tree
from serl_tpu_torch.vision.mobilenet_v1 import (
    MobileNetV1,
    load_tf_slim_params,
    make_mobilenet_encoder,
)
from tests.test_mobilenet_v1 import synthetic_tf_slim_ckpt
from tests.test_torch_gc_sac import update_parity
from tests.test_torch_resnet import recording_dropout

WIDTH = 0.25
ATOL = 1e-4
HEAD = dict(pooling_method="spatial_learned_embeddings", num_spatial_blocks=4, bottleneck_dim=16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt():
    out = {}
    for k, v in synthetic_tf_slim_ckpt(np.random.RandomState(0), width=WIDTH).items():
        if k.endswith("weights"):  # He scale: N(0, 2 / fan_in)
            fan = v.shape[0] * v.shape[1] * (1 if "depthwise" in k else v.shape[2])
            v = v * (np.sqrt(2.0 / fan) / 0.1)
        elif k.endswith(("beta", "moving_mean")):
            v = v * 0.1
        elif k.endswith("gamma"):  # U(0.5, 1.5) -> U(0.8, 1.2)
            v = 0.8 + 0.4 * (v - 0.5)
        elif k.endswith("moving_variance"):  # U(0.1, 1.1) -> U(0.8, 1.2)
            v = 0.8 + 0.4 * (v - 0.1)
        out[k] = v.astype(np.float32)
    return out


def _equal_trees(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(jax.device_get(want))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), got, want)
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(got))


def test_torch_tf_slim_import_matches_jax(ckpt, tmp_path):
    want = jax_load(ckpt, width=WIDTH)
    _equal_trees(load_tf_slim_params(ckpt, WIDTH), want)
    bare = {k[len("MobilenetV1/"):]: v for k, v in ckpt.items()}  # no root prefix
    _equal_trees(load_tf_slim_params(bare, WIDTH), want)
    np.savez(tmp_path / "m.npz", **ckpt)
    with open(tmp_path / "m.pkl", "wb") as f:
        pickle.dump(bare, f)
    _equal_trees(load_tf_slim_params(str(tmp_path / "m.npz"), WIDTH), want)
    _equal_trees(load_tf_slim_params(str(tmp_path / "m.pkl"), WIDTH), want)
    # the depthwise kernels in flax's grouped layout (H, W, 1, C)
    assert want["conv1_dw"]["kernel"].shape == (3, 3, 1, 8)


@pytest.mark.parametrize("size", [32, 40])
def test_torch_mobilenet_v1_matches_flax(ckpt, size):
    params = jax_load(ckpt, width=WIDTH)
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = JaxMobileNetV1(width=WIDTH).apply({"params": params}, x)
    net = MobileNetV1(WIDTH, size).load_params(load_tf_slim_params(ckpt, WIDTH))
    got = net(torch.from_numpy(x)).detach()
    assert tuple(got.shape) == np.shape(want) == (2,) + net.feature_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert float((got[0] - got[1]).abs().max()) > 100 * ATOL  # the features follow the image
    # relu6: the features are clipped at 6 on both sides
    assert float(got.max()) <= 6.0 and float(got.min()) >= 0.0
    # the loader checks every shape: TF-slim's (H, W, C, 1) depthwise layout is refused
    raw = load_tf_slim_params(ckpt, WIDTH)
    raw["conv1_dw"]["kernel"] = np.transpose(raw["conv1_dw"]["kernel"], (0, 1, 3, 2))
    with pytest.raises(ValueError, match="conv1_dw"):
        MobileNetV1(WIDTH, size).load_params(raw)


def test_torch_frozen_encoder_matches_flax(ckpt, monkeypatch):
    params = jax_load(ckpt, width=WIDTH)
    imgs = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    jenc = jax_make_encoder(params, width=WIDTH, **HEAD)
    enc = make_mobilenet_encoder(load_tf_slim_params(ckpt, WIDTH), WIDTH, 32, **HEAD)
    pairs = _head_pairs((), enc)
    head = jax.tree.map(lambda a: a + np.float32(0.05), pairs_to_tree(pairs))
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), imgs, train=False))["params"]
    assert jax.tree.map(np.shape, head) == jax.tree.map(lambda a: tuple(a.shape), shapes)
    load_pairs(pairs, head)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jenc.apply({"params": head}, imgs, train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    assert len(masks) == 1 and tuple(masks[0].shape) == (3, enc.dropout_features)
    got = enc(torch.from_numpy(imgs), train=True, dropout=masks[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the backbone's tensors are buffers: no optimizer sees them
    names = {n for n, _ in enc.named_parameters()}
    assert names and not any(n.startswith("backbone") for n in names)
    assert sum(1 for n, _ in enc.named_buffers() if n.startswith("backbone")) == 2 * 27 + 27
    # a given map: the head alone
    maps = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 1, 1, 256)).astype(np.float32))
    want_head = jenc.apply({"params": head}, maps.numpy(), train=False, encode=False)
    np.testing.assert_allclose(enc(maps, encode=False).detach().numpy(), np.asarray(want_head),
                               atol=ATOL, rtol=0)


class _EvalInit(JaxFrozenBackboneEncoder):
    """JAX's frozen encoder with `train` defaulting to False: SACAgent.create
    inits its encoder with the default, which in train mode needs a dropout
    rng that init does not pass (tests/test_goal_conditioned.py uses "avg"
    pooling for that reason). The update passes train=True itself."""

    def __call__(self, observations, train: bool = False, encode: bool = True):
        return super().__call__(observations, train=train, encode=encode)


def test_torch_sac_update_through_frozen_mobilenet_matches_jax(ckpt, monkeypatch):
    params = jax_load(ckpt, width=WIDTH)
    backbone = JaxMobileNetV1(width=WIDTH)
    jencoder = _EvalInit(backbone_apply=lambda p, x: backbone.apply({"params": p}, x),
                         backbone_params=params, **HEAD)
    encoder = make_mobilenet_encoder(load_tf_slim_params(ckpt, WIDTH), WIDTH, 32, **HEAD)
    frozen = {n: b.clone() for n, b in encoder.named_buffers() if n.startswith("backbone")}
    rng = np.random.default_rng(5)

    def obs(n):
        return rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)

    batch = {"observations": obs(4), "next_observations": obs(4),
             "actions": rng.uniform(-0.95, 0.95, (4, 4)).astype(np.float32),
             "rewards": rng.normal(size=(4,)).astype(np.float32),
             "masks": np.ones((4,), np.float32), "dones": np.zeros((4,), np.float32)}
    agent, _, _ = update_parity(jencoder, encoder, obs(1), batch, monkeypatch, masks_per_pass=1)
    assert all(torch.equal(b, frozen[n]) for n, b in agent.encoder.named_buffers()
               if n.startswith("backbone"))
    critic = {id(p) for p in agent.state.params["critic"]}
    assert not any(id(b) in critic for b in agent.encoder.backbone.buffers())
