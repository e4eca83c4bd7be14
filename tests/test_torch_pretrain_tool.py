"""The port's ResNet-10 pretraining tool against the JAX package's
`tools/pretrain_resnet10.py`, on the CPU, at 2 envs x 3 steps, 32 px frames
and batch 4.

- `collect_frames`: the JAX tool's own `collect_frames` (loaded from its
  file) and the port's, the port fed JAX's draws (the reset and auto-reset
  cube positions from each env's key, the expert noise and the uniform
  actions from the scan key's splits): the frames under tests/torch_k2.py's
  pixel rule (equal here), the labels within LABEL_ATOL (the physics of the
  two packages round differently: 4.6e-6 m measured).
- `Regressor` with the JAX tool's `_Regressor` init grafted into it: the
  outputs within OUT_ATOL; `train=True` switches nothing on in either ("avg"
  pooling, no bottleneck: flax would ask for a dropout rng otherwise); the
  label statistics (population std) within 1e-6.
- `train_step`: two Adam steps beside optax.adam(3e-4) on JAX's batch
  indices. From the tool's zero moments, the first step maps a gradient g to
  g / (|g| + 1e-8): where g is near 0 the two packages' rounding moves a
  param by up to a learning rate, so the params are held within PARAM_ATOL
  except for at most ILL_SHARE of them, none beyond the learning rate
  (measured: 12 of 4,972,230 beyond 1e-5, the largest 1.2e-4). From
  synthetic mid-run moments (count 100, nu 1e-4), where the step is
  well-conditioned, every param within PARAM_ATOL (1.2e-7 measured). The
  losses within LOSS_RTOL.
- `export_backbone`: the same keys, shapes, float16 dtype and values as the
  JAX tool's export of the same params; the file grafted by
  `serl_tpu/utils/pretrained.py::load_resnet10_params` and by the port's
  `graft_resnet10` gives frozen features within FEATURE_ATOL (the fp32 rule
  of tests/test_torch_resnet.py), and the port's grafted tensors equal the
  file's float16 values exactly.
- `main` end to end at a tiny size on the CPU.
"""

import importlib.util
import pickle
import types
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serl_tpu.envs.panda_pick import SAMPLING_BOUNDS
from serl_tpu.envs.panda_pick import PandaPickCubeEnv as JaxPickEnv
from serl_tpu.utils import pretrained as jpretrained
from serl_tpu.vision.encoders import resnetv1_configs as jax_resnets
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.tools import pretrain_resnet10 as tool
from serl_tpu_torch.utils import jax_params
from serl_tpu_torch.utils.jax_params import load_pairs, pairs_to_tree, resnet_pairs
from serl_tpu_torch.utils.pretrained import graft_resnet10, read_params
from serl_tpu_torch.vision.encoders import PreTrainedResNetEncoder, resnetv1_configs
from tests.torch_k2 import pixel_rule

ROOT = Path(__file__).resolve().parents[1]
N, T, SIZE, BATCH = 2, 3, 32, 4
LABEL_ATOL = 2e-5
OUT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
ILL_ATOL = 1e-5
ILL_SHARE = 1e-5
LR = 3e-4
FEATURE_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtool():
    """The JAX tool's module, loaded from its file (its import sets JAX's
    compilation cache directory: put the test run's back)."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("jax_pretrain_resnet10",
                                                  ROOT / "tools" / "pretrain_resnet10.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def jax_frame_draws(jenv, rng, num_envs: int, steps: int) -> tool.FrameDraws:
    """The JAX tool's random numbers for `collect_frames(env, rng, ...)`:
    each env's reset from split(rng, N), its auto-reset position from the
    key the reset leaves in its state, and per step (rng, ka, kn) =
    split(rng, 3) from fold_in(rng, 1): the expert's normal(k, (4,)) for
    each of split(ka, N), uniform(kn, (N, 4), -1, 1)."""
    states, _ = jax.vmap(jenv.reset)(jax.random.split(rng, num_envs))

    def auto_xy(key):
        _, k_block, _ = jax.random.split(key, 3)
        return jax.random.uniform(k_block, (2,), minval=SAMPLING_BOUNDS[0],
                                  maxval=SAMPLING_BOUNDS[1])

    noise, uniform, key = [], [], jax.random.fold_in(rng, 1)
    for _ in range(steps):
        key, ka, kn = jax.random.split(key, 3)
        noise.append(jax.vmap(lambda k: jax.random.normal(k, (4,)))(jax.random.split(ka,
                                                                                    num_envs)))
        uniform.append(jax.random.uniform(kn, (num_envs, 4), minval=-1, maxval=1))
    t = lambda x: torch.from_numpy(np.array(x))
    return tool.FrameDraws(t(states.physics.cube_pos[:, :2]),
                           t(np.stack([np.asarray(jax.vmap(auto_xy)(states.rng))] * steps)),
                           t(np.stack(noise)), t(np.stack(uniform)))


@pytest.fixture(scope="module")
def collected(jtool):
    jenv = JaxPickEnv(image_obs=True, render_size=SIZE)
    rng = jax.random.PRNGKey(0)
    frames, labels = jtool.collect_frames(jenv, rng, N, T)
    env = PandaPickCubeEnv(image_obs=True, render_size=SIZE, device="cpu")
    got = tool.collect_frames(env, N, T, jax_frame_draws(jenv, rng, N, T))
    return np.array(frames), np.array(labels), got


def test_torch_collect_frames_matches_the_jax_tool(collected):
    jframes, jlabels, (frames, labels) = collected
    assert frames.shape == jframes.shape == (N * T, SIZE, SIZE, 3)
    assert frames.dtype == torch.uint8 and labels.shape == (N * T, 6)
    failures, summary = pixel_rule(frames, torch.from_numpy(jframes))
    assert not failures, (failures, summary)
    np.testing.assert_allclose(labels.numpy(), jlabels, atol=LABEL_ATOL, rtol=0)
    # successive steps of one env differ: the frames are time-major as JAX's
    assert not np.array_equal(frames[0].numpy(), frames[N].numpy())


def _regressor_pairs(model: tool.Regressor):
    return (resnet_pairs(model.backbone, ("backbone",))
            + jax_params._dense(("Dense_0",), model.dense0)
            + jax_params._dense(("Dense_1",), model.dense1))


def _grafted_pair(jtool, frames):
    """(JAX tool's _Regressor, its init params at PRNGKey(1), the port's
    Regressor holding them)."""
    backbone = jax_resnets["resnetv1-10"](pooling_method="avg", name="pretrained_encoder")
    jmodel = jtool._Regressor(backbone=backbone)
    params = jmodel.init(jax.random.PRNGKey(1), frames[:1], train=False)["params"]
    assert sorted(params) == ["Dense_0", "Dense_1", "backbone"]
    model = tool.Regressor(image_size=SIZE)
    load_pairs(_regressor_pairs(model), jax.device_get(params))
    return jmodel, params, model


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(tree)])


def test_torch_regressor_and_train_step_match_the_jax_tool(jtool, collected):
    jframes, jlabels, _ = collected
    jmodel, params, model = _grafted_pair(jtool, jframes)
    want = np.asarray(jmodel.apply({"params": params}, jframes, train=True))
    np.testing.assert_array_equal(want, np.asarray(jmodel.apply({"params": params}, jframes,
                                                                train=False)))
    frames, labels = torch.from_numpy(jframes), torch.from_numpy(jlabels)
    got = model(frames, train=True).detach()
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL, rtol=0)
    torch.testing.assert_close(got, model(frames, train=False).detach(), atol=0, rtol=0)
    mu, sd = jlabels.mean(axis=0), jlabels.std(axis=0) + 1e-6
    tmu, tsd = tool.label_stats(labels)
    np.testing.assert_allclose(tmu.numpy(), mu, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tsd.numpy(), sd, atol=1e-6, rtol=0)
    n = jframes.shape[0]
    tx = optax.adam(LR)

    @jax.jit
    def jax_step(p, opt_state, idx):  # the JAX tool's train_step, on explicit indices
        x = jnp.take(jframes, idx, axis=0)
        y = (jnp.take(jlabels, idx, axis=0) - mu) / sd

        def loss_fn(q):
            return jnp.mean((jmodel.apply({"params": q}, x, train=True) - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    for synthetic in (False, True):
        if synthetic:
            _, params, model = _grafted_pair(jtool, jframes)
        opt = tool.make_optimizer(LR)
        jstate, ostate = tx.init(params), opt.init(list(model.parameters()))
        if synthetic:
            jstate = (optax.ScaleByAdamState(
                count=jnp.asarray(100, jnp.int32), mu=jax.tree.map(jnp.zeros_like, params),
                nu=jax.tree.map(lambda x: jnp.full_like(x, 1e-4), params)), jstate[1])
            ostate.count = 100
            for v in ostate.nu:
                v.fill_(1e-4)
        key = jax.random.PRNGKey(2)
        for step in range(2):
            key, k = jax.random.split(key)
            idx = jax.random.randint(k, (BATCH,), 0, n)
            params, jstate, jloss = jax_step(params, jstate, idx)
            ostate, loss = tool.train_step(model, opt, ostate, frames, labels, tmu, tsd,
                                           torch.from_numpy(np.array(idx)).long())
            np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
            diff = np.abs(_flat(pairs_to_tree(_regressor_pairs(model)))
                          - _flat(jax.device_get(params)))
            where = ("synthetic moments" if synthetic else "zero moments", step)
            if synthetic:
                assert diff.max() <= PARAM_ATOL, (where, diff.max())
            else:
                assert (diff > ILL_ATOL).mean() <= ILL_SHARE, (where, (diff > ILL_ATOL).sum())
                assert diff.max() <= LR, (where, diff.max())


@flax.struct.dataclass
class _JaxState:
    params: dict
    target_params: dict


@flax.struct.dataclass
class _JaxAgent:
    state: _JaxState


def test_torch_export_matches_the_jax_export_and_grafts_in_both(jtool, collected, tmp_path,
                                                                monkeypatch):
    jframes = collected[0]
    jmodel, params, model = _grafted_pair(jtool, jframes)
    path = tmp_path / "resnet10_params.pkl"
    tree = tool.export_backbone(model, str(path))
    want = jax.tree.map(lambda x: np.asarray(x, np.float16), jax.device_get(params["backbone"]))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), tree, want)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert jax.tree.map(lambda x: (x.shape, x.dtype), raw) == jax.tree.map(
        lambda x: (x.shape, np.dtype(np.float16)), want)

    # the file grafted by the JAX package's loader into a frozen ResNet-10
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(path))
    frozen = jax_resnets["resnetv1-10-frozen"](name="pretrained_encoder")
    init = frozen.init(jax.random.PRNGKey(7), jframes[:1], train=False)["params"]
    nest = lambda p: {"critic": {"encoder": {"encoders_image": {"pretrained_encoder": p}}}}
    agent = jpretrained.load_resnet10_params(
        _JaxAgent(_JaxState(nest(init), nest(init))), ("image",), strict=True)
    grafted = agent.state.params["critic"]["encoder"]["encoders_image"]["pretrained_encoder"]
    want_features = np.asarray(frozen.apply({"params": grafted}, jframes, train=False))
    # ... and by the port's
    enc = PreTrainedResNetEncoder(resnetv1_configs["resnetv1-10-frozen"](image_size=SIZE))
    tensors = graft_resnet10(types.SimpleNamespace(encoders={"image": enc}), ("image",))
    assert len(tensors) == len(list(enc.pretrained_encoder.parameters()))
    file_values = read_params(str(path))
    for p, tensor, layout in resnet_pairs(enc.pretrained_encoder):
        node = file_values
        for k in p:
            node = node[k]
        value = torch.from_numpy(node.astype(np.float32))
        assert torch.equal(tensor, value.permute(3, 2, 0, 1) if layout == "HWIO" else value), p
    got = enc.pretrained_encoder(torch.from_numpy(jframes))
    np.testing.assert_allclose(got.numpy(), want_features, atol=FEATURE_ATOL, rtol=0)


def test_torch_pretrain_main_runs_on_cpu(tmp_path):
    out = tmp_path / "sub" / "r10.pkl"
    result = tool.main(["--device", "cpu", "--num_envs", "2", "--rollout_steps", "2",
                        "--steps", "2", "--batch_size", "2", "--out", str(out)])
    assert result["frames"].shape == (4, 128, 128, 3) and result["losses"].shape == (2,)
    assert bool(torch.isfinite(result["losses"]).all())
    assert sorted(read_params(str(out))) == sorted(read_params(str(ROOT / "resnet10_params.pkl")))
    assert tool.parser().parse_args([]).out == str(Path("runs") / "resnet10_params.pkl")
