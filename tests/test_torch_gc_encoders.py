"""The goal- and language-conditioned encoders and what they reach, against
serl_tpu, on the CPU.

- FiLM and multiplicative conditioning, the bottleneck block and the
  deeper ResNet registry (resnetv1-18, -34-bridge-film, -50: num_filters
  8, 32 x 24 px), the SmallEncoder's "SAME" and explicit padding and its
  learned-embedding and softmax heads, `is_encoded` (a head over given
  maps), GCObsEncoder (early and late fusion) and LCObsEncoder: flax's
  params, perturbed away from init (so FiLM's zero-initialised Dense
  layers and the bottleneck block's zero GroupNorm scale are nonzero), are
  carried into the port by `utils/jax_params.py`. Tolerances: the SmallEncoder
  heads 1e-5 abs; the ResNets tests/test_torch_resnet.py's fp32 rule,
  2e-5 abs and 2e-5 mean abs.
The SAC updates through these encoders are tests/test_torch_gc_sac.py's.
The planted faults this file catches: FiLM's add and mult swapped (every
conditioned case), symmetric "SAME" pads (the SmallEncoder's stride-2 case).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.vision import encoders as jenc
from serl_tpu.vision.encoding import GCObsEncoder as JaxGCObsEncoder
from serl_tpu.vision.encoding import LCObsEncoder as JaxLCObsEncoder
from serl_tpu.vision.encoding import ObsEncoder as JaxObsEncoder
from serl_tpu_torch.utils.jax_params import (
    _encoder_pairs,
    load_pairs,
    pairs_to_tree,
    resnet_pairs,
)
from serl_tpu_torch.vision import encoders as tenc
from serl_tpu_torch.vision.encoding import GCObsEncoder, LCObsEncoder, ObsEncoder
from tests.test_torch_resnet import recording_dropout

H, W = 32, 24
RESNET_TOL = (2e-5, 2e-5)  # (max abs, mean abs), tests/test_torch_resnet.py's fp32 rule
HEAD_ATOL = 1e-5
COND = 12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(size=np.shape(x)))
                        .astype(np.float32), jax.device_get(params))


def _images(n, seed=0, h=H, w=W, c=3):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c)).astype(np.uint8)


def _close_resnet(got, want):
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert err.max() <= RESNET_TOL[0] and err.mean() <= RESNET_TOL[1], (err.max(), err.mean())


# ---------------------------------------------------------------- ResNets


RESNET_CASES = {
    # name: (registry key, flax kwargs, port kwargs)
    "resnetv1-18": ("resnetv1-18", {}, {}),
    "resnetv1-50": ("resnetv1-50", dict(pooling_method="spatial_softmax"), {}),
    "resnetv1-34-bridge-film": ("resnetv1-34-bridge-film",
                                dict(pooling_method="spatial_learned_embeddings",
                                     bottleneck_dim=16), dict(cond_dim=COND)),
    # multiplicative conditioning: its Dense_i come before the bottleneck's
    "resnetv1-18-mult-cond": ("resnetv1-18-bridge",
                              dict(use_multiplicative_cond=True, bottleneck_dim=16),
                              dict(use_multiplicative_cond=True, cond_dim=COND)),
}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_torch_resnet_registry_matches_flax(case, monkeypatch):
    key, jkw, tkw = RESNET_CASES[case]
    x = _images(2, seed=1)
    cond = np.random.default_rng(2).normal(size=(2, COND)).astype(np.float32)
    conditioned = "cond_dim" in tkw
    jmod = jenc.resnetv1_configs[key](num_filters=8, **jkw)
    call = dict(cond_var=cond) if conditioned else {}
    mod = tenc.resnetv1_configs[key](num_filters=8, image_size=(H, W), **{**jkw, **tkw})
    pairs = resnet_pairs(mod)
    # the port's tree has flax's structure and shapes (traced, not run: a
    # deep flax init runs for tens of seconds on the CPU), and its
    # perturbed values go to both sides
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, train=False, **call))
    params = _perturbed(pairs_to_tree(pairs), 3)
    assert (jax.tree.map(np.shape, params)
            == jax.tree.map(lambda a: tuple(a.shape), shapes["params"]))
    load_pairs(pairs, params)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jmod.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(4)},
                          **call)
    tcall = dict(cond_var=torch.from_numpy(cond)) if conditioned else {}
    got = mod(torch.from_numpy(x), train=True, dropout=masks[0] if masks else None, **tcall)
    assert tuple(got.shape) == np.shape(want)
    _close_resnet(got, want)
    if key == "resnetv1-50":  # the bottleneck block's last GroupNorm scale starts at zero
        fresh = tenc.resnetv1_configs[key](num_filters=8, image_size=(H, W))
        assert all(not bool(b.norms[2].weight.any()) for b in fresh.blocks)
    if mod.films is not None:
        # FiLM is the identity at init, and a swap of add and mult is another function
        fresh = tenc.FilmConditioning(COND, 8)
        h = torch.randn(2, 8, 3, 3)
        assert torch.equal(fresh(h, torch.from_numpy(cond)), h)
        for film in mod.films:
            film.add, film.mult = film.mult, film.add
        swapped = mod(torch.from_numpy(x), train=True, dropout=masks[0], **tcall)
        assert (swapped - got).abs().max() > 1e-2


def test_torch_film_matches_flax():
    rng = np.random.default_rng(5)
    x, cond = rng.normal(size=(3, 4, 5, 6)).astype(np.float32), rng.normal(size=(3, COND))
    cond = cond.astype(np.float32)
    jfilm = jenc.FilmConditioning()
    params = _perturbed(jfilm.init(jax.random.PRNGKey(0), x, cond)["params"], 6)
    want = jfilm.apply({"params": params}, x, cond)
    film = tenc.FilmConditioning(COND, 6)
    load_pairs([(("Dense_0", "kernel"), film.add.weight, "T"), (("Dense_0", "bias"), film.add.bias, None),
                (("Dense_1", "kernel"), film.mult.weight, "T"),
                (("Dense_1", "bias"), film.mult.bias, None)], params)
    got = film(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(cond)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_ATOL, rtol=0)


# ---------------------------------------------------------------- SmallEncoder


SMALL_CASES = {
    "same_sle": dict(padding="SAME", pool_method="spatial_learned_embeddings"),
    "explicit_softmax": dict(padding=(1, 2), pool_method="spatial_softmax"),
    "same_max_no_bottleneck": dict(padding="SAME", pool_method="max", bottleneck_dim=None),
}


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_torch_small_encoder_padding_and_heads_match_flax(case, monkeypatch):
    kw = dict(features=(8, 16), kernel_sizes=(3, 3), strides=(2, 2), bottleneck_dim=16,
              spatial_block_size=4)
    kw.update(SMALL_CASES[case])
    x = _images(3, seed=7)
    jmod = jenc.SmallEncoder(**kw)
    params = _perturbed(jmod.init(jax.random.PRNGKey(1), x)["params"], 8)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jmod.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(5)})
    mod = tenc.SmallEncoder(3, image_size=(H, W), **kw)
    enc = ObsEncoder({"image": mod}, ("image",), 0, use_proprio=False)
    load_pairs(_encoder_pairs(enc, root=()), {"encoders_image": params})
    assert len(masks) == int(mod.dropout_features > 0)
    got = mod(torch.from_numpy(x), train=True, dropout=masks[0] if masks else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_ATOL, rtol=0)
    if case == "same_sle":  # the planted fault: symmetric "SAME" pads move the features
        real = tenc.conv2d_same
        monkeypatch.setattr(tenc, "conv2d_same", lambda x, w, s, groups=1, bias=None: torch.nn.
                            functional.conv2d(x, w, bias, stride=s, padding=w.shape[-1] // 2))
        sym = mod(torch.from_numpy(x), train=True, dropout=masks[0])
        monkeypatch.setattr(tenc, "conv2d_same", real)
        assert sym.shape == got.shape and (sym - got).abs().max() > 1e-3


def test_torch_is_encoded_runs_the_heads_alone():
    """ObsEncoder(is_encoded=True): each camera's pre-pooling map through its
    head only (a pretrained ResNet head skips its backbone), then proprio."""
    backbone = lambda: jenc.ResNetEncoder(stage_sizes=(1, 1), num_filters=8, pre_pooling=True)
    jencs = {k: jenc.PreTrainedResNetEncoder(pretrained_encoder=backbone(), pooling_method="avg",
                                             bottleneck_dim=16, name=f"encoder_{k}")
             for k in ("a", "b")}
    jobs = JaxObsEncoder(encoders=jencs, image_keys=("a", "b"))
    rng = np.random.default_rng(10)
    obs = {"state": rng.normal(size=(3, 5)).astype(np.float32),
           **{k: _images(3, seed=11 + i)[:, None] for i, k in enumerate("ab")}}
    params = _perturbed(jobs.init(jax.random.PRNGKey(0), obs)["params"], 12)
    maps = {"state": obs["state"],
            **{k: rng.normal(size=(3, 4, 3, 16)).astype(np.float32) for k in "ab"}}
    want = jobs.apply({"params": params}, maps, is_encoded=True)
    tencs = {k: tenc.PreTrainedResNetEncoder(
        tenc.ResNetEncoder((1, 1), num_filters=8, pre_pooling=True, image_size=(H, W)),
        "avg", bottleneck_dim=16) for k in "ab"}
    enc = ObsEncoder(tencs, ("a", "b"), 5)
    load_pairs(_encoder_pairs(enc, root=()), params)
    got = enc({k: torch.from_numpy(v) for k, v in maps.items()}, is_encoded=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_ATOL, rtol=0)


# ---------------------------------------------------------------- GC / LC encoders


def _small(jax_side, **kw):
    kw = dict(features=(8, 16), kernel_sizes=(3, 3), strides=(2, 2), bottleneck_dim=16, **kw)
    return jenc.SmallEncoder(**kw) if jax_side else tenc.SmallEncoder(kw.pop("in_channels", 3),
                                                                      **kw)


def _film_resnet(jax_side):
    kw = dict(stage_sizes=(1, 1), num_filters=8, use_film=True)
    return (jenc.ResNetEncoder(**kw) if jax_side
            else tenc.ResNetEncoder(cond_dim=COND, image_size=(H, W), **kw))


ENCODERS = {
    # name: (flax encoder, port encoder, proprio width)
    "gc_early": (lambda: JaxGCObsEncoder(encoder=_small(True), use_proprio=True),
                 lambda: GCObsEncoder(_small(False, in_channels=6), use_proprio=True,
                                      proprio_dim=5), 5),
    "gc_late": (lambda: JaxGCObsEncoder(encoder=_small(True), goal_encoder=_small(True)),
                lambda: GCObsEncoder(_small(False), _small(False)), 0),
    "lc_film": (lambda: JaxLCObsEncoder(encoder=_film_resnet(True), use_proprio=True),
                lambda: LCObsEncoder(_film_resnet(False), use_proprio=True, proprio_dim=5), 5),
}


def _pairs_obs(name, n, seed):
    rng = np.random.default_rng(seed)
    obs = {"image": _images(n, seed), "proprio": rng.normal(size=(n, 5)).astype(np.float32)}
    goal = ({"language": rng.normal(size=(n, COND)).astype(np.float32)} if name.startswith("lc")
            else {"image": _images(n, seed + 1)})
    return obs, goal


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_torch_gc_lc_encoders_match_flax(name):
    jfac, tfac, proprio = ENCODERS[name]
    x = _pairs_obs(name, 3, 20)
    jmod = jfac()
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), x)["params"], 21)
    want = jmod.apply({"params": params}, x)
    enc = tfac()
    load_pairs(_encoder_pairs(enc, root=()), params)
    got = enc(_to(x, torch.from_numpy))
    assert tuple(got.shape) == np.shape(want) and got.shape[-1] == enc.out_features
    (_close_resnet(got, want) if name.startswith("lc")
     else np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=HEAD_ATOL))
    if name == "gc_early":  # the 6-channel input: obs then goal channels
        assert enc.encoder.convs[0].in_channels == 6
