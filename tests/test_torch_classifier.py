"""The reward classifier against serl_tpu's, on the CPU.

- `BinaryClassifier` over a float32 SmallEncoder (narrow, 32 px), its flax
  params perturbed and grafted into the port (`utils/jax_params.py::
  classifier_pairs`): eval-mode logits, and train-mode logits with flax's
  own dropout mask (recorded as flax draws it); 2e-5 abs (logits of order 1,
  convolution sums in another order than XLA's).
- `create_classifier` at the registry's full width: "small" (bf16
  convolutions in both packages: 0.05 abs on the logits, the bf16 rounding
  of the encoder features, tests/test_torch_encoder.py's, carried through
  the head) and "resnet-pretrained" on the committed backbone (fp32: 1e-4
  abs); the port's flax tree has JAX's structure and shapes, and its
  backbone holds the pickle's values.
- One `classifier_train_step` from mid-run Adam moments (a first step from
  zero moments maps g to g / |g|, which is ill-conditioned): the loss, the
  accuracy and every param after the step, 2e-6 abs.
- A file saved by either package loads in the other: `save_classifier` ->
  `load_classifier_func` both ways, "resnet-pretrained" through JAX's own
  `load_classifier_func`, "small" through the pickle and JAX's apply. JAX's
  `create_classifier("resnet-pretrained")` looks the camera up as
  `encoder_<key>` (flax names it `encoders_<key>`) and raises a KeyError
  when it finds the pickle, so the JAX side runs here with its pickle lookup
  turned off (it then keeps a random backbone, which the loaded file
  replaces).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serl_tpu.networks import classifier as jcls
from serl_tpu.utils import pretrained as jpretrained
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu.vision.encoding import ObsEncoder as JaxObsEncoder
from serl_tpu_torch.networks import classifier as cls
from serl_tpu_torch.utils import pretrained
from serl_tpu_torch.utils.jax_params import classifier_pairs, load_pairs, pairs_to_tree
from serl_tpu_torch.vision.encoders import SmallEncoder
from serl_tpu_torch.vision.encoding import ObsEncoder
from tests.test_torch_resnet import PKL, recording_dropout

KEY = "front"
SIZE = 32
FEATURES = (8, 16, 16, 32)
ATOL_F32 = 2e-5
ATOL_BF16 = 0.05
ATOL_RESNET = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture()
def committed_pkl(monkeypatch):
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(PKL))
    return PKL


@pytest.fixture()
def jax_without_pickle(monkeypatch):
    """JAX's resnet-pretrained classifier without its (misnamed) graft."""
    monkeypatch.setattr(jpretrained, "_find_params_file", lambda: None)


def _frames(n, seed, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (n, 1, size, size, 3)).astype(np.uint8)


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + scale * rng.normal(size=x.shape)
                        .astype(np.float32), params)


def _narrow():
    """(JAX classifier def, port classifier) over a float32 narrow SmallEncoder."""
    jenc = JaxObsEncoder(encoders={KEY: JaxSmallEncoder(features=FEATURES, bottleneck_dim=32,
                                                        compute_dtype=jnp.float32)},
                         use_proprio=False, image_keys=(KEY,))
    enc = ObsEncoder({KEY: SmallEncoder(3, FEATURES, bottleneck_dim=32)}, (KEY,), 0,
                     use_proprio=False)
    return jcls.BinaryClassifier(encoder_def=jenc), cls.BinaryClassifier(enc)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=0, err_msg=msg)


def test_torch_binary_classifier_matches_flax_eval_and_train(monkeypatch):
    jdef, tdef = _narrow()
    x = _frames(6, 0)
    params = _perturbed(jdef.init(jax.random.PRNGKey(0), {KEY: x})["params"], 1)
    load_pairs(classifier_pairs(tdef), params)
    tx = {KEY: torch.from_numpy(x)}
    _close(tdef(tx), jdef.apply({"params": params}, {KEY: x}), ATOL_F32, "eval")
    masks = recording_dropout(monkeypatch)
    want = jdef.apply({"params": params}, {KEY: x}, train=True,
                      rngs={"dropout": jax.random.PRNGKey(4)})
    assert len(masks) == 1 and masks[0].shape == (6, 256)
    got = tdef(tx, train=True, dropout=masks[0])
    _close(got, want, ATOL_F32, "train")
    assert not torch.allclose(got, tdef(tx))  # the mask acts
    # the encoded pass-through and the head on given features
    feats = tdef(tx, return_encoded=True)
    _close(feats, jdef.apply({"params": params}, {KEY: x}, return_encoded=True), ATOL_F32)
    _close(tdef(feats, classify_encoded=True), jdef.apply({"params": params}, {KEY: x}),
           ATOL_F32)
    with pytest.raises(ValueError, match="keep-mask"):
        tdef(tx, train=True)  # every draw is the caller's


def test_torch_classifier_head_takes_flax_layer_norm_eps():
    """The head's LayerNorm has flax's eps, 1e-6: on features of spread ~1e-3
    (pre-norm variance ~1e-6) torch's default 1e-5 would move every logit."""
    jdef, tdef, params = _narrow_pair_with_params(15)
    feats = (1e-3 * np.random.default_rng(16).normal(size=(8, 32))).astype(np.float32)
    want = jdef.apply({"params": params}, feats, classify_encoded=True)
    got = tdef(torch.from_numpy(feats), classify_encoded=True)
    _close(got, want, ATOL_F32, "small-spread features")
    assert tdef.head.norm.eps == 1e-6


def test_torch_create_classifier_small_matches_jax():
    x = _frames(4, 2)
    jstate = jcls.create_classifier(jax.random.PRNGKey(0), {KEY: x[:1]}, (KEY,),
                                    encoder_type="small")
    state = cls.create_classifier({KEY: torch.from_numpy(x[:1])}, (KEY,), encoder_type="small",
                                  generator=torch.Generator().manual_seed(0), device="cpu")
    tree = pairs_to_tree(classifier_pairs(state.classifier))
    want_shapes = jax.tree.map(np.shape, jax.device_get(jstate.params))
    assert jax.tree.map(np.shape, tree) == want_shapes  # flax's names and shapes
    params = _perturbed(jax.device_get(jstate.params), 3, 0.02)
    cls.load_classifier_params(state, params)
    got = cls.classifier_fn(state)({KEY: torch.from_numpy(x)})
    want = jstate.apply_fn({"params": params}, {KEY: x}, train=False)
    _close(got, want, ATOL_BF16, "bf16 small classifier")


def test_torch_create_classifier_resnet_pretrained_on_committed_backbone(
        committed_pkl, jax_without_pickle):
    x = _frames(2, 5)
    state = cls.create_classifier({KEY: torch.from_numpy(x[:1])}, (KEY,),
                                  generator=torch.Generator().manual_seed(0), device="cpu")
    tree = pairs_to_tree(classifier_pairs(state.classifier))
    raw = pretrained.read_params(str(PKL))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b.astype(np.float32)),
                 tree["encoder_def"][f"encoders_{KEY}"]["pretrained_encoder"], raw)
    jstate = jcls.create_classifier(jax.random.PRNGKey(0), {KEY: x[:1]}, (KEY,))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jax.device_get(jstate.params))
    want = jstate.apply_fn({"params": jax.tree.map(jnp.asarray, tree)}, {KEY: x}, train=False)
    _close(cls.classifier_fn(state)({KEY: torch.from_numpy(x)}), want, ATOL_RESNET)
    with pytest.raises(KeyError, match="encoder_front"):  # the JAX package's misnamed graft
        jax_graft = jpretrained._find_params_file
        try:
            jpretrained._find_params_file = lambda: str(PKL)
            jcls.create_classifier(jax.random.PRNGKey(0), {KEY: x[:1]}, (KEY,))
        finally:
            jpretrained._find_params_file = jax_graft


def test_torch_create_classifier_is_strict(tmp_path, monkeypatch):
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(tmp_path / "missing.pkl"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="resnet10_params.pkl"):
        cls.create_classifier({KEY: torch.zeros(1, 1, SIZE, SIZE, 3, dtype=torch.uint8)},
                              (KEY,), device="cpu")


def _moments(params, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda x: (1e-3 * rng.normal(size=np.shape(x))).astype(np.float32), params)
    nu = jax.tree.map(lambda x: (1e-5 * (1.0 + rng.uniform(size=np.shape(x)))).astype(np.float32),
                      params)
    return mu, nu


def _load_moments(state, mu, nu, count):
    pairs = classifier_pairs(state.classifier)
    index = {id(p): i for i, p in enumerate(state.params)}
    opt = state.opt_state
    for tree, target in ((mu, opt.mu), (nu, opt.nu)):
        load_pairs([(path, target[index[id(t)]], layout) for path, t, layout in pairs], tree)
    opt.count = count


def test_torch_classifier_train_step_matches_jax(monkeypatch):
    jdef, tdef = _narrow()
    x = _frames(8, 6)
    params = _perturbed(jdef.init(jax.random.PRNGKey(1), {KEY: x})["params"], 7)
    load_pairs(classifier_pairs(tdef), params)
    mu, nu = _moments(params, 8)
    tx = optax.adam(1e-4)
    opt = tx.init(jax.tree.map(jnp.asarray, params))
    opt = (opt[0]._replace(count=jnp.asarray(5, jnp.int32), mu=jax.tree.map(jnp.asarray, mu),
                           nu=jax.tree.map(jnp.asarray, nu)),) + tuple(opt[1:])
    jstate = jcls.ClassifierState(step=jnp.zeros((), jnp.int32),
                                  params=jax.tree.map(jnp.asarray, params), opt_state=opt,
                                  apply_fn=jdef.apply, tx=tx)
    labels = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        jnew, jinfo = jcls.classifier_train_step(jstate, {"observations": {KEY: x},
                                                          "labels": jnp.asarray(labels)},
                                                 jax.random.PRNGKey(9))
    assert len(masks) == 1
    state = cls.ClassifierState(tdef)
    _load_moments(state, mu, nu, 5)
    batch = {"observations": {KEY: torch.from_numpy(x)}, "labels": torch.from_numpy(labels)}
    state, info = cls.classifier_train_step(state, batch, draws={"head": masks[0], "encoder": {}})
    np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]), rtol=1e-5)
    assert float(info["accuracy"]) == float(jinfo["accuracy"])
    assert state.step == 1 and state.opt_state.count == 6
    got = pairs_to_tree(classifier_pairs(tdef))
    jax.tree.map(lambda a, b: _close(a, b, 2e-6), got, jax.device_get(jnew.params))


def _narrow_pair_with_params(seed):
    jdef, tdef = _narrow()
    params = _perturbed(jdef.init(jax.random.PRNGKey(seed), {KEY: _frames(1, 0)})["params"], seed)
    load_pairs(classifier_pairs(tdef), params)
    return jdef, tdef, params


def test_torch_classifier_file_resnet_pretrained_both_ways(tmp_path, committed_pkl,
                                                           jax_without_pickle):
    x = _frames(3, 11)
    sample = {KEY: x[:1]}
    tsample = {KEY: torch.from_numpy(x[:1])}
    # port -> JAX
    state = cls.create_classifier(tsample, (KEY,), generator=torch.Generator().manual_seed(4),
                                  device="cpu")
    cls.load_classifier_params(state, _perturbed(pairs_to_tree(classifier_pairs(
        state.classifier)), 12, 0.01))
    path = str(tmp_path / "port.pkl")
    cls.save_classifier(state, path)
    jfn = jcls.load_classifier_func(jax.random.PRNGKey(0), sample, (KEY,), path)
    want = cls.classifier_fn(state)({KEY: torch.from_numpy(x)})
    _close(want, jfn({KEY: x}), ATOL_RESNET, "port file in JAX")
    # JAX -> port
    jstate = jcls.create_classifier(jax.random.PRNGKey(2), sample, (KEY,))
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, _perturbed(
        jax.device_get(jstate.params), 13, 0.01)))
    path = str(tmp_path / "jax.pkl")
    jcls.save_classifier(jstate, path)
    fn = cls.load_classifier_func(tsample, (KEY,), path, device="cpu")
    _close(fn({KEY: torch.from_numpy(x)}), jcls.classifier_fn(jstate)({KEY: x}), ATOL_RESNET,
           "JAX file in the port")


def test_torch_classifier_file_small_both_ways(tmp_path):
    x = _frames(3, 14)
    tsample = {KEY: torch.from_numpy(x[:1])}
    jstate = jcls.create_classifier(jax.random.PRNGKey(3), {KEY: x[:1]}, (KEY,),
                                    encoder_type="small")
    # port -> JAX: the pickle through JAX's apply
    state = cls.create_classifier(tsample, (KEY,), encoder_type="small",
                                  generator=torch.Generator().manual_seed(5), device="cpu")
    path = str(tmp_path / "port.pkl")
    cls.save_classifier(state, path)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    want = jstate.apply_fn({"params": jax.tree.map(jnp.asarray, tree)}, {KEY: x}, train=False)
    _close(cls.classifier_fn(state)({KEY: torch.from_numpy(x)}), want, ATOL_BF16)
    # JAX -> port
    path = str(tmp_path / "jax.pkl")
    jcls.save_classifier(jstate, path)
    fn = cls.load_classifier_func(tsample, (KEY,), path, encoder_type="small", device="cpu")
    _close(fn({KEY: torch.from_numpy(x)}), jcls.classifier_fn(jstate)({KEY: x}), ATOL_BF16)


def test_torch_train_reward_classifier_from_pickles(tmp_path):
    """The entry point with --pos / --neg demo pickles: its flags, 3 steps of
    the bf16 registry classifier on 32 px frames, and a file that JAX's
    small classifier applies."""
    from serl_tpu_torch.examples import train_reward_classifier as trc

    args = trc.parser().parse_args([])
    assert (args.image_key, args.encoder, args.num_epochs, args.batch_size, args.out,
            args.seed) == ("front", "small", 100, 128, "classifier.pkl", 0)
    for name, lo, hi in (("pos", 150, 256), ("neg", 0, 100)):
        frames = np.random.default_rng(lo).integers(lo, hi, (6, SIZE, SIZE, 3)).astype(np.uint8)
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump({"observations": {KEY: frames}}, f)
    out = str(tmp_path / "classifier.pkl")
    state = trc.main(["--pos", str(tmp_path / "pos.pkl"), "--neg", str(tmp_path / "neg.pkl"),
                      "--num_epochs", "3", "--batch_size", "8", "--out", out, "--device", "cpu"])
    assert state.step == 3
    with open(out, "rb") as f:
        tree = pickle.load(f)
    jstate = jcls.create_classifier(jax.random.PRNGKey(0), {KEY: _frames(1, 0)}, (KEY,),
                                    encoder_type="small")
    x = _frames(2, 17)
    want = jstate.apply_fn({"params": jax.tree.map(jnp.asarray, tree)}, {KEY: x}, train=False)
    _close(cls.classifier_fn(state)({KEY: torch.from_numpy(x)}), want, ATOL_BF16)
