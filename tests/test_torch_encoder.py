"""The pixel encoders against flax, on the CPU.

`SmallEncoder` (narrow: features (8, 16, 16, 32), bottleneck 32) and
`ObsEncoder` (front and wrist cameras plus the 7-dim proprio state) are
built by both packages; flax's params, perturbed away from their zero
biases, are grafted into the port (conv kernels HWIO -> OIHW, dense kernels
transposed, LayerNorm scale -> weight). Tolerances:
  * compute_dtype float32, which tests the algorithm: 2e-6 abs (outputs in
    (-1, 1); convolution sums of up to 144 terms taken in another order);
  * compute_dtype bfloat16, the DrQ setting: 0.05 abs and 0.005 mean abs.
    The two frameworks round the bf16 convolutions at different places (the
    bias add, the accumulation), each rounding being ~0.4% of a value, and the
    four layers and the LayerNorm carry it into the features (measured here:
    at most 0.016, mean 0.0014).
The full-width DrQ agent's parameter tree carries flax's names and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu.vision.encoding import ObsEncoder as JaxObsEncoder
from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.utils.jax_params import load_encoder_params, to_jax_layout
from serl_tpu_torch.vision.encoders import SmallEncoder
from serl_tpu_torch.vision.encoding import ObsEncoder, fold_stack

FEATURES = (8, 16, 16, 32)
KEYS = ("front", "wrist")
TOL = {"float32": (2e-6, 2e-6), "bfloat16": (0.05, 0.005)}  # (max abs, mean abs)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
                        params)


def _close(got, want, dtype):
    atol, mean = TOL[dtype]
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert err.max() <= atol and err.mean() <= mean, (dtype, err.max(), err.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_small_encoder_matches_flax(dtype):
    jenc = JaxSmallEncoder(features=FEATURES, bottleneck_dim=32, compute_dtype=getattr(jnp, dtype))
    x = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    p = _perturbed(jenc.init(jax.random.PRNGKey(0), x)["params"], 1)
    enc = SmallEncoder(3, FEATURES, bottleneck_dim=32, compute_dtype=getattr(torch, dtype))
    with torch.no_grad():
        for i, conv in enumerate(enc.convs):
            conv.weight.copy_(torch.from_numpy(p[f"Conv_{i}"]["kernel"]).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(p[f"Conv_{i}"]["bias"]))
        enc.bottleneck.dense.weight.copy_(torch.from_numpy(p["Dense_0"]["kernel"]).T)
        enc.bottleneck.dense.bias.copy_(torch.from_numpy(p["Dense_0"]["bias"]))
        enc.bottleneck.norm.weight.copy_(torch.from_numpy(p["LayerNorm_0"]["scale"]))
        enc.bottleneck.norm.bias.copy_(torch.from_numpy(p["LayerNorm_0"]["bias"]))
    got = enc(torch.from_numpy(x))
    assert got.shape == (4, 32) and got.dtype == torch.float32
    _close(got, jenc.apply({"params": p}, x), dtype)


@pytest.mark.parametrize("dtype,stack,shared", [("float32", 2, False), ("bfloat16", 1, False),
                                                ("float32", 1, True)])
def test_torch_obs_encoder_matches_flax(dtype, stack, shared):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if shared:
        one = JaxSmallEncoder(features=FEATURES, bottleneck_dim=32, compute_dtype=jdt,
                              name="encoder_shared")
        jencs = {k: one for k in KEYS}
        tone = SmallEncoder(3 * stack, FEATURES, bottleneck_dim=32, compute_dtype=tdt)
        tencs = {k: tone for k in KEYS}
    else:
        jencs = {k: JaxSmallEncoder(features=FEATURES, bottleneck_dim=32, compute_dtype=jdt,
                                    name=f"encoder_{k}") for k in KEYS}
        tencs = {k: SmallEncoder(3 * stack, FEATURES, bottleneck_dim=32, compute_dtype=tdt)
                 for k in KEYS}
    jenc = JaxObsEncoder(encoders=jencs, image_keys=KEYS, shared_batch_concat=True)
    rng = np.random.default_rng(2)
    obs = {"state": rng.normal(size=(5, 7)).astype(np.float32),
           **{k: rng.integers(0, 256, (5, stack, 32, 32, 3)).astype(np.uint8) for k in KEYS}}
    p = _perturbed(jenc.init(jax.random.PRNGKey(0), obs)["params"], 3)
    enc = ObsEncoder(tencs, KEYS, 7, shared_batch_concat=True)
    load_encoder_params(enc, p)
    got = enc({k: torch.from_numpy(v) for k, v in obs.items()})
    assert got.shape == (5, 2 * 32 + 64) == (5, enc.out_features)
    _close(got, jenc.apply({"params": p}, obs), dtype)
    # the frame stack folds into channels, oldest frame first
    img = torch.from_numpy(obs["front"])
    folded = fold_stack(img)
    assert folded.shape == (5, 32, 32, 3 * stack)
    torch.testing.assert_close(folded[..., -3:], img[:, -1], rtol=0, atol=0)


def test_torch_drq_param_tree_matches_flax_names():
    """The full-width DrQ agent (small encoders, 10-member critic) at 32 px:
    the port's params in the JAX layout have flax's paths and shapes."""
    obs = {"state": np.zeros((1, 7), np.float32),
           **{k: np.zeros((1, 1, 32, 32, 3), np.uint8) for k in KEYS}}
    kwargs = dict(image_keys=KEYS, critic_ensemble_size=10, critic_subsample_size=2,
                  critic_network_kwargs={"hidden_dims": (256, 256), "use_layer_norm": True},
                  policy_network_kwargs={"hidden_dims": (256, 256), "use_layer_norm": True})
    jagent = JaxDrQAgent.create_drq(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, obs),
                                    jnp.zeros((1, 4)), **kwargs)
    agent = DrQAgent.create_drq({k: torch.from_numpy(v) for k, v in obs.items()},
                                torch.zeros(1, 4), generator=torch.Generator().manual_seed(0),
                                device="cpu", **kwargs)
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(to_jax_layout(agent)) == shapes(jagent.state.params)
    assert agent.critic.trunk.dense[0].kernel.shape == (10, 2 * 256 + 64 + 4, 256)
    # flax initialises conv and dense kernels with lecun_normal: variance 1 / fan_in
    conv = agent.encoder.encoders["front"].convs[1].weight.detach()
    assert abs(float(conv.std()) * np.sqrt(32 * 9) - 1.0) < 0.1
