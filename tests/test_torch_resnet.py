"""The ResNet encoders, their pooling heads and the pretrained graft against
flax and serl_tpu, on the CPU.

Narrow ResNets (num_filters 8, two stages, 32 x 24 px so that h != w) and
the pooling heads are built by both packages; flax's params, perturbed
away from their initial values (GroupNorm scales of one, zero biases), are
carried into the port by `utils/jax_params.py::resnet_pairs`. The full
ResNet-10 of `resnet10_params.pkl` is grafted by both packages' loaders.

Tolerances:
  * fp32 (the algorithm): 2e-5 abs on the features. Convolution sums of up
    to 3 x 3 x 64 terms and GroupNorm's statistics (flax: E[x^2] - E[x]^2;
    torch: the centred form) are taken in another order, and the
    normalisations rescale those rounding errors (measured here: at most
    5.7e-6);
  * bf16 convolutions (the "resnet" setting): 0.05 abs and 0.005 mean abs,
    the SmallEncoder's bf16 rule (tests/test_torch_encoder.py): the two
    frameworks round the bf16 convolutions at different places;
  * padding, max-pool, coordinates, dropout, the graft: exact where both
    sides compute the same values (a copy, a select, a cast).
The planted faults this file catches: symmetric padding in place of flax's
"SAME" (the stride-2 cases and the ResNet), dropout left off in train mode
(the learned-embedding head with flax's masks), a graft that transposes the
kernels' spatial axes (the graft against JAX's).
"""

import os
import pickle
import warnings
from pathlib import Path

import flax.linen as fnn
import flax.linen.stochastic as stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.vision import encoders as jenc
from serl_tpu.vision.encoding import ObsEncoder as JaxObsEncoder
from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.utils import pretrained
from serl_tpu_torch.utils.jax_params import (
    load_encoder_params,
    load_pairs,
    resnet_pairs,
    to_jax_layout,
)
from serl_tpu_torch.vision import encoders as tenc
from serl_tpu_torch.vision.encoding import ObsEncoder
from tests import torch_resnet

PKL = Path(__file__).resolve().parent.parent / "resnet10_params.pkl"
KEYS = ("front", "wrist")
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (0.05, 0.005)}  # (max abs, mean abs)
H, W = 32, 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(size=np.shape(x)))
                        .astype(np.float32), params)


def _close(got, want, dtype):
    atol, mean = TOL[dtype]
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert err.max() <= atol and err.mean() <= mean, (dtype, err.max(), err.mean())


def _images(n, seed=0, h=H, w=W, c=3):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c)).astype(np.uint8)


def recording_dropout(monkeypatch):
    """Record every dropout keep-mask flax draws, in call order (JAX run
    eagerly, under jax.disable_jit, so each mask is a concrete array)."""
    masks = []
    real = stochastic.random

    class Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def bernoulli(key, p, shape):
            mask = real.bernoulli(key, p=p, shape=shape)
            masks.append(torch.from_numpy(np.asarray(mask)))
            return mask

    monkeypatch.setattr(stochastic, "random", Recorder())
    return masks


# ---------------------------------------------------------------- padding


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 2), (9, 3, 2), (8, 3, 1), (8, 1, 2),
                                                (7, 7, 2)])
def test_torch_same_padding_matches_flax(size, kernel, stride):
    rng = np.random.default_rng(size + kernel)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), (stride, stride), use_bias=False)
    p = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(p, x))
    w = torch.from_numpy(np.asarray(p["params"]["kernel"])).permute(3, 2, 0, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tenc.conv2d_same(xt, w, stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if (size, kernel, stride) == (8, 3, 2):
        # the trap: symmetric padding is another function with the same shape
        sym = F.conv2d(xt, w, stride=2, padding=1).permute(0, 2, 3, 1)
        assert sym.shape == got.shape and np.abs(sym.numpy() - want).max() > 0.5

    pooled = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    got = tenc.max_pool_same(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, pooled)
    if size % 2 == 0:
        sym = F.max_pool2d(xt, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
        assert sym.shape == pooled.shape and np.abs(sym - pooled).max() > 0.1


# ---------------------------------------------------------------- ResNet


RESNET_CASES = {
    # name: (compute dtype, flax kwargs); the basic block throughout
    "basic_sle_fp32": ("float32", dict(pooling_method="spatial_learned_embeddings",
                                       bottleneck_dim=16)),
    "basic_sle_bf16": ("bfloat16", dict(pooling_method="spatial_learned_embeddings",
                                        bottleneck_dim=16)),  # the "resnet" encoder's head
    "basic_avg_bf16": ("bfloat16", dict(pooling_method="avg")),
    "basic_max_fp32": ("float32", dict(pooling_method="max")),
    "layer_softmax_coords_fp32": ("float32", dict(norm="layer", pooling_method="spatial_softmax",
                                                  add_spatial_coordinates=True)),
    "none_swish_fp32": ("float32", dict(pooling_method="none", act="swish")),
    "pre_pooling_fp32": ("float32", dict(pre_pooling=True)),
}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_torch_resnet_encoder_matches_flax(case):
    dtype, kw = RESNET_CASES[case]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _images(3, seed=1)
    jmod = jenc.ResNetEncoder(stage_sizes=(1, 1), num_filters=8, compute_dtype=jdt, **kw)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), x, train=False)["params"], 3)
    want = jmod.apply({"params": params}, x, train=False)
    mod = tenc.ResNetEncoder((1, 1), num_filters=8, compute_dtype=tdt, image_size=(H, W), **kw)
    load_pairs(resnet_pairs(mod), params)
    got = mod(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(want))
    _close(got, want, dtype)
    if kw.get("pre_pooling"):
        assert mod.feature_shape == np.shape(want)[1:] and not got.requires_grad
        assert got.grad_fn is None  # computed under no_grad: nothing saved for autograd


@pytest.mark.parametrize("method", ["spatial_learned_embeddings", "spatial_softmax", "avg", "max"])
def test_torch_pooling_heads_match_flax(method, monkeypatch):
    """Each pooling head on a (B, h, w, c) map with h != w, in train mode:
    the learned embeddings' dropout takes flax's own keep-mask."""
    rng = np.random.default_rng(4)
    maps = rng.normal(size=(5, 4, 3, 6)).astype(np.float32)

    class Head(fnn.Module):
        @fnn.compact
        def __call__(self, x, train):
            return jenc._pool(x, method, 8, train)

    head = Head()
    variables = head.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                          maps, train=True)
    params = _perturbed(variables.get("params", {}), 5)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = head.apply({"params": params}, maps, train=True,
                          rngs={"dropout": jax.random.PRNGKey(2)})
    pool = tenc.Pool(method, (6, 4, 3), 8)
    if method == "spatial_learned_embeddings":
        load_pairs([(("SpatialLearnedEmbeddings_0", "kernel"), pool.embeddings.kernel, None)],
                   params)
        assert len(masks) == 1 and pool.dropout_features == 6 * 8
    x = torch.from_numpy(maps).permute(0, 3, 1, 2)
    got = pool(x, train=True, dropout_mask=masks[0] if masks else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)
    if method == "spatial_learned_embeddings":  # and without train, no dropout
        no_drop = jax.jit(lambda m: head.apply({"params": params}, m, train=False))(maps)
        np.testing.assert_allclose(pool(x).detach().numpy(), np.asarray(no_drop), atol=2e-6,
                                   rtol=0)
        assert not torch.equal(pool(x), got)


def test_torch_add_spatial_coordinates_matches_flax():
    x = np.random.default_rng(6).normal(size=(2, 5, 4, 3)).astype(np.float32)
    want = jenc.AddSpatialCoordinates().apply({}, x)
    got = tenc.add_spatial_coordinates(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_torch_dropout_in_train_mode_takes_the_callers_mask():
    """Every draw is the caller's: train mode without a keep-mask raises
    (no unseeded draw from torch's global generator); without train mode
    the features pass unchanged."""
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    assert tenc.dropout(x, train=False) is x
    with pytest.raises(ValueError, match="keep-mask"):
        tenc.dropout(x, train=True)
    pool = tenc.Pool("spatial_learned_embeddings", (2, 2, 2), 8,
                     generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="keep-mask"):
        pool(torch.randn(3, 2, 2, 2), train=True)
    mask = torch.rand(3, 16, generator=torch.Generator().manual_seed(2)) < 0.9
    torch.testing.assert_close(tenc.dropout(x, True, mask), torch.where(mask, x / 0.9, 0.0),
                               atol=0, rtol=0)


def test_torch_obs_encoder_with_resnet_heads_matches_flax(monkeypatch):
    """ObsEncoder over two cameras, each a pretrained-style head (learned
    embeddings, dropout, bottleneck) over its own narrow pre-pooling
    ResNet, in train mode with flax's masks (one per camera, in key order)."""
    backbone = lambda: jenc.ResNetEncoder(stage_sizes=(1, 1), num_filters=8, pre_pooling=True)
    jencs = {k: jenc.PreTrainedResNetEncoder(pretrained_encoder=backbone(),
                                             pooling_method="spatial_learned_embeddings",
                                             num_spatial_blocks=8, bottleneck_dim=16,
                                             name=f"encoder_{k}") for k in KEYS}
    jobs = JaxObsEncoder(encoders=jencs, image_keys=KEYS, shared_batch_concat=True)
    rng = np.random.default_rng(9)
    obs = {"state": rng.normal(size=(4, 7)).astype(np.float32),
           **{k: rng.integers(0, 256, (4, 1, H, W, 3)).astype(np.uint8) for k in KEYS}}
    params = _perturbed(jobs.init(jax.random.PRNGKey(0), obs)["params"], 10)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jobs.apply({"params": params}, obs, train=True,
                          rngs={"dropout": jax.random.PRNGKey(3)})
    assert len(masks) == 2
    tencs = {k: tenc.PreTrainedResNetEncoder(
        tenc.ResNetEncoder((1, 1), num_filters=8, pre_pooling=True, image_size=(H, W)),
        "spatial_learned_embeddings", 8, 16) for k in KEYS}
    enc = ObsEncoder(tencs, KEYS, 7, shared_batch_concat=True)
    load_encoder_params(enc, params)
    assert enc.dropout_shapes(4) == {k: (4, 16 * 8) for k in KEYS}
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    got = enc(tobs, train=True, dropout=dict(zip(KEYS, masks)))
    _close(got, want, "float32")
    # the masks act: the same features without them differ
    assert not torch.allclose(enc(tobs), got)
    want_eval = jobs.apply({"params": params}, obs)  # acting: no dropout
    _close(enc(tobs), want_eval, "float32")


# ---------------------------------------------------------------- the graft


def _obs(n=1, size=32):
    return {"state": np.zeros((n, 7), np.float32),
            **{k: np.zeros((n, 1, size, size, 3), np.uint8) for k in KEYS}}


def _port_agent(**kw):
    return DrQAgent.create_drq({k: torch.from_numpy(v) for k, v in _obs().items()},
                               torch.zeros(1, 4), encoder_type="resnet-pretrained",
                               image_keys=KEYS, generator=torch.Generator().manual_seed(0),
                               device="cpu", critic_ensemble_size=2, **kw)


@pytest.fixture()
def committed_pkl(monkeypatch):
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(PKL))
    return PKL


def test_torch_graft_matches_jax(committed_pkl):
    """create_drq("resnet-pretrained") grafts the committed pickle into both
    cameras' backbones and the target critic's copies: the port's params in
    the JAX layout equal JAX's graft exactly (a float16 -> fp32 cast)."""
    jagent = JaxDrQAgent.create_drq(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _obs()),
                                    jnp.zeros((1, 4)), encoder_type="resnet-pretrained",
                                    image_keys=KEYS, critic_ensemble_size=2)
    agent = _port_agent()
    got = to_jax_layout(agent)["critic"]["encoder"]
    raw = pretrained.read_params(str(PKL))
    for k in KEYS:
        want = jax.device_get(jagent.state.params["critic"]["encoder"][f"encoders_{k}"]
                              ["pretrained_encoder"])
        jax.tree.map(lambda a, b, c: (np.testing.assert_array_equal(a, np.asarray(b)),
                                      np.testing.assert_array_equal(a, c.astype(np.float32))),
                     got[f"encoders_{k}"]["pretrained_encoder"], want, raw)
    group, targets = agent.state.params["critic"], agent.state.target_params["critic"]
    assert all(torch.equal(p, t) for p, t in zip(group, targets))


def _write(tmp_path, tree, name="bad.pkl"):
    path = tmp_path / name
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return str(path)


def test_torch_graft_strict_errors(tmp_path, monkeypatch):
    """As tests/test_pretrained.py holds JAX's under strict: a missing file,
    a missing module, a module whose tree or shapes differ, nothing grafted:
    each raises (the port's loader is always strict), and a failed graft
    leaves the agent as it was."""
    monkeypatch.chdir(tmp_path)  # no ./resnet10_params.pkl
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(tmp_path / "nope.pkl"))
    with pytest.raises(FileNotFoundError):
        _port_agent()
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(PKL))
    agent = _port_agent()
    before = [p.clone() for p in agent.parameters()]
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(tmp_path / "nope.pkl"))
    with pytest.raises(FileNotFoundError, match="no random-init"):
        pretrained.load_resnet10_params(agent, KEYS)
    assert all(torch.equal(p, q) for p, q in zip(agent.parameters(), before))

    raw = pretrained.read_params(str(PKL))
    bad = {
        KeyError: {k: v for k, v in raw.items() if k != "ResNetBlock_2"},
        ValueError: {**raw, "norm_init": {"scale": raw["norm_init"]["scale"]}},
    }
    shapes = dict(raw)
    shapes["conv_init"] = {"kernel": np.zeros((7, 7, 3, 32), np.float16)}
    for exc, tree in list(bad.items()) + [(ValueError, shapes)]:
        monkeypatch.setenv("SERL_RESNET10_PARAMS", _write(tmp_path, tree))
        with pytest.raises(exc):
            pretrained.load_resnet10_params(agent, KEYS)
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(PKL))
    with pytest.raises(KeyError, match="no modules"):
        pretrained.load_resnet10_params(agent, ())


def test_torch_graft_pickle_reader(tmp_path, monkeypatch):
    """The reader takes numpy's array classes only, and reads numpy 2's
    `numpy._core` names under numpy 1.x (no `numpy._core`) as `numpy.core`."""
    with pytest.raises(pickle.UnpicklingError):
        pretrained.read_params(_write(tmp_path, {"x": os.getcwd}, "other.pkl"))
    asked = []

    class Spy(pickle.Unpickler):
        def find_class(self, module, name):
            asked.append(module)
            return super().find_class(module, name)

    class Reader(pretrained._NumpyUnpickler, Spy):  # Spy sees what the reader asks for
        pass

    monkeypatch.setattr(pretrained, "np", type("NumpyOne", (), {}))
    with open(PKL, "rb") as f, warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # numpy 2's numpy.core shim
        tree = Reader(f).load()
    assert "numpy.core.multiarray" in asked and not any(m.startswith("numpy._core") for m in asked)
    assert tree["conv_init"]["kernel"].shape == (7, 7, 3, 64)
    np.testing.assert_array_equal(tree["conv_init"]["kernel"],
                                  pretrained.read_params(str(PKL))["conv_init"]["kernel"])


def test_torch_tf32_feature_rule_on_the_cpu():
    """chip_smoke.py's rule for the card's backbone features
    (tests/torch_resnet.py): TF32 rounding ties to even at 10 mantissa bits;
    the emulated TF32 features of a narrow backbone sit near, not at, its
    fp32 features and pass the rule; features of a backbone whose stem
    kernel is spatially transposed fail it."""
    one = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -10)])
    np.testing.assert_array_equal(torch_resnet.tf32_round(one).numpy(),
                                  np.array([1, 1 + 2.0 ** -9, 1, -(1 + 2.0 ** -10)], np.float32))
    mod = tenc.ResNetEncoder((1, 1), num_filters=8, pre_pooling=True, image_size=(H, W),
                             generator=torch.Generator().manual_seed(0))
    frames = torch.from_numpy(_images(4, seed=11))
    fp32 = mod(frames)
    emulated = torch_resnet.tf32_features(mod, frames)
    failures, summary = torch_resnet.judge(emulated, fp32, emulated)
    assert not failures and 0 < summary["tf32_emulated_max"] < 1e-2 * summary["max_abs_feature"]
    assert tenc.F is F  # the emulation put torch's functional back
    with torch.no_grad():
        mod.conv_init.weight.copy_(mod.conv_init.weight.transpose(2, 3).clone())
    failures, _ = torch_resnet.judge(mod(frames), fp32, emulated)
    assert failures
