"""The photometric augmentations and the SmallEncoder's stem switches
against serl_tpu's, on the CPU.

- `rgb_to_hsv`, `hsv_to_rgb`, `to_grayscale` on random float images with
  grey, black and saturated pixels among them; `color_transform` in order,
  shuffled with grayscale, and not applied; `gaussian_blur` at two kernel
  radii and not applied; `random_flip` and `solarize` either way. Every
  draw is JAX's, taken from the same key splits (augmentations.py:144-147,
  151-178, 206-207, 220, 227). Tolerance 1e-5 abs (divisions and exp in
  float32, summed in another order), 1e-6 for the blur.
- `SmallEncoder(pad_input_channels=4)` and `SmallEncoder(space_to_depth_stem=True)`
  (and both), narrow and float32, with flax's params grafted: features to
  1e-5 abs on random uint8 images; the padded stem's extra kernel taps see
  zeros, so it computes the plain encoder's function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.vision import augmentations as jaug
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu_torch.utils.jax_params import _encoder_pairs, load_pairs
from serl_tpu_torch.vision import augmentations as aug
from serl_tpu_torch.vision.encoders import SmallEncoder

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _image(seed, shape=(16, 12, 3)):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    img[0, :3] = 0.5  # grey: r == g == b
    img[1, :3] = 0.0  # black
    img[2, 0] = (1.0, 0.0, 0.0)  # saturated primaries
    img[2, 1] = (0.0, 1.0, 0.0)
    img[2, 2] = (0.0, 0.0, 1.0)
    return img


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_torch_hsv_and_grayscale_match_jax():
    img = _image(0)
    hsv = aug.rgb_to_hsv(torch.from_numpy(img))
    _close(hsv, jaug.rgb_to_hsv(jnp.asarray(img)), what="rgb_to_hsv")
    _close(aug.hsv_to_rgb(hsv), jaug.hsv_to_rgb(jnp.asarray(hsv.numpy())), what="hsv_to_rgb")
    _close(aug.hsv_to_rgb(hsv), img, atol=1e-5, what="round trip")
    _close(aug.to_grayscale(torch.from_numpy(img)), jaug.to_grayscale(jnp.asarray(img)),
           what="to_grayscale")


def _color_draws(key, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05):
    """color_transform's draws from its key (augmentations.py:144-178)."""
    keys = jax.random.split(key, 8)
    u = lambda k, lo=0.0, hi=1.0: _t(jax.random.uniform(k, (), minval=lo, maxval=hi))
    return {"apply": u(keys[0]), "gray": u(keys[1]), "jitter": u(keys[2]),
            "brightness": u(keys[3], -brightness, brightness),
            "contrast": u(keys[4], 1 - contrast, 1 + contrast),
            "saturation": u(keys[5], 1 - saturation, 1 + saturation),
            "hue": u(keys[6], -hue, hue),
            "order": _t(jax.random.permutation(keys[7], 4)).long()}


@pytest.mark.parametrize("kw", [{}, {"shuffle": True, "to_grayscale_prob": 1.0},
                                {"apply_prob": 0.0}, {"color_jitter_prob": 0.0,
                                                      "to_grayscale_prob": 1.0}])
def test_torch_color_transform_matches_jax(kw):
    img = _image(1)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jaug.color_transform(jnp.asarray(img), key, **kw)
        got = aug.color_transform(torch.from_numpy(img), _color_draws(key), **kw)
        _close(got, want, what=f"{kw} {seed}")
    drawn = aug.color_draws(torch.Generator().manual_seed(0))
    assert sorted(drawn["order"].tolist()) == [0, 1, 2, 3]
    assert aug.color_transform(torch.from_numpy(img), drawn).shape == img.shape


@pytest.mark.parametrize("shape,apply_prob", [((32, 32, 3), 1.0), ((64, 48, 3), 1.0),
                                              ((32, 32, 3), 0.0)])
def test_torch_gaussian_blur_matches_jax(shape, apply_prob):
    img = _image(2, shape)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    draws = {"apply": _t(jax.random.uniform(k1)),
             "sigma": _t(jax.random.uniform(k2, (), minval=0.1, maxval=2.0))}
    want = jaug.gaussian_blur(jnp.asarray(img), key, apply_prob=apply_prob)
    got = aug.gaussian_blur(torch.from_numpy(img), draws, apply_prob=apply_prob)
    _close(got, want, atol=1e-6)
    assert float(aug.blur_draws(torch.Generator().manual_seed(0))["sigma"]) >= 0.1


def test_torch_flip_and_solarize_match_jax():
    img = _image(4)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        u = _t(jax.random.uniform(key))
        _close(aug.random_flip(torch.from_numpy(img), u), jaug.random_flip(jnp.asarray(img), key),
               atol=0)
        for kw in ({}, {"threshold": 0.3, "apply_prob": 0.4}):
            _close(aug.solarize(torch.from_numpy(img), u, **kw),
                   jaug.solarize(jnp.asarray(img), key, **kw), atol=0)


FEATURES, BOTTLENECK = (4, 8, 8, 16), 16


@pytest.mark.parametrize("kw", [{"pad_input_channels": 4}, {"space_to_depth_stem": True},
                                {"pad_input_channels": 4, "space_to_depth_stem": True}])
def test_torch_small_encoder_stem_switches_match_jax(kw):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    jenc = JaxSmallEncoder(features=FEATURES, bottleneck_dim=BOTTLENECK,
                           compute_dtype=jnp.float32, **kw)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"])
    enc = SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK, **kw)
    load_pairs(_encoder_pairs(enc, root=()), params)
    want = jenc.apply({"params": params}, jnp.asarray(images))
    _close(enc(torch.from_numpy(images)), want, what=str(kw))
    stem = enc.convs[0].weight
    cin = 4 if "pad_input_channels" in kw else 3
    assert stem.shape == ((FEATURES[0], 4 * cin, 2, 2) if "space_to_depth_stem" in kw
                          else (FEATURES[0], cin, 3, 3))
    if kw == {"pad_input_channels": 4}:
        # the extra input channel's taps multiply zeros: the 3-channel
        # encoder with the first three channels' kernel computes the same
        plain = SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK)
        plain.load_state_dict({k: (v[:, :3] if k == "convs.0.weight" else v)
                               for k, v in enc.state_dict().items()})
        torch.testing.assert_close(plain(torch.from_numpy(images)),
                                   enc(torch.from_numpy(images)), atol=1e-5, rtol=0)
