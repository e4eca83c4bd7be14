"""The DrQ agent with the trainable "resnet" encoder against serl_tpu's, on the CPU.

`update_high_utd` with a trained ResNet-10 per camera (32 px; critic and
policy width 32, a 4-member critic subsampled to 2), in two settings: the
registry's "resnet" (bf16 convolutions), and the same ResNet-10 and head
with fp32 convolutions, given to both packages as custom encoders, which
holds the algorithm (the backbone's backward through the convolutions,
GroupNorm and the residuals) apart from bf16's rounding. The JAX agent's
params, all perturbed, its target critic apart from them and a mid-run
optimizer state are carried into the port, and one update_high_utd (UTD 1:
a critic update, then an actor+temperature update) runs in both on the
same batch with every draw JAX's own, the dropout keep-masks recorded from
flax as in tests/test_torch_resnet_drq.py.

Tolerances (measured on this machine's CPU in brackets):
  * fp32: params and targets 2e-6 abs [1.2e-7], Adam's first moments 2e-6
    [2.2e-7], the infos 2e-5 relative [5.3e-6], each backbone tensor's step
    at a cosine of at least 0.9999 to JAX's [1 - 1.2e-7];
  * bf16: the two frameworks round the convolutions at different places
    (tests/test_torch_resnet.py holds the forward to 0.05 abs), and through
    ten layers the losses move by 1-2%; params and targets 2e-3 abs [7.4e-4,
    steps of up to 1.3e-3], first moments 2e-2 [7.8e-3: 0.1 x the
    gradients' spread], the infos 5e-2 relative [1.6e-2], each backbone
    tensor's step at a cosine of at least 0.97 to JAX's [0.994], so that a
    backbone that does not train, or trains another way, fails;
  * the second moments at the first moments' tolerance squared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.vision.encoders import resnetv1_configs as jax_resnets
from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.utils.jax_params import load_train_state, train_state_to_jax_layout
from serl_tpu_torch.vision.encoders import resnetv1_configs as port_resnets
from tests.test_torch_drq import _batch, _jb, _tb, jax_augment_draws
from tests.test_torch_learner import (
    assert_trees_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.test_torch_resnet import recording_dropout
from tests.test_torch_resnet_drq import ACT, ACTOR_PASSES, CRITIC_PASSES, E, KEYS, S, _example
from tests.test_torch_resnet_drq import _kwargs as _pretrained_kwargs

# (params and targets atol, first moments atol, infos rtol, least cosine of a backbone step)
TOL = {"float32": (2e-6, 2e-6, 2e-5, 0.9999), "bfloat16": (2e-3, 2e-2, 5e-2, 0.97)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kwargs():
    return {**_pretrained_kwargs(), "encoder_type": "resnet"}


def _encoders(dtype):
    """Both packages' encoders: the registry's "resnet" (bf16), or the same
    ResNet-10 and head with fp32 convolutions, given as custom encoders."""
    if dtype == "bfloat16":
        return {}, {}
    head = dict(pooling_method="spatial_learned_embeddings", num_spatial_blocks=8,
                bottleneck_dim=256)
    jax_encs = {k: jax_resnets["resnetv1-10"](compute_dtype=jnp.float32, name=f"encoder_{k}",
                                              **head) for k in KEYS}
    g = torch.Generator().manual_seed(1)
    port_encs = {k: port_resnets["resnetv1-10"](image_size=32, generator=g, **head) for k in KEYS}
    return {"custom_encoders": jax_encs}, {"custom_encoders": port_encs}


def _backbone_steps(before, after):
    """{path: (before, after)} of every backbone leaf of both cameras."""
    out = {}
    for k in KEYS:
        enc_b = before["params"]["critic"]["encoder"][f"encoders_{k}"]
        enc_a = after["params"]["critic"]["encoder"][f"encoders_{k}"]
        for path, leaf in jax.tree_util.tree_flatten_with_path(enc_b)[0]:
            name = jax.tree_util.keystr(path)
            if "ResNetBlock" in name or "conv_init" in name or "norm_init" in name:
                sub = enc_a
                for p in path:
                    sub = sub[p.key]
                out[f"{k}{name}"] = (np.asarray(leaf), np.asarray(sub))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_resnet_update_high_utd_matches_jax(dtype, monkeypatch):
    jax_encs, port_encs = _encoders(dtype)
    jagent = JaxDrQAgent.create_drq(jax.random.PRNGKey(0), _jb(_example()), jnp.zeros((1, ACT)),
                                    **_kwargs(), **jax_encs)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape))
                          .astype(np.float32), jax.device_get(jagent.state.params))
    target = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape))
                          .astype(np.float32), {"critic": params["critic"]})
    start = jax_state_np(jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target))))
    for o in start["opt_states"].values():
        o["mu"] = jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape)).astype(np.float32),
                               o["mu"])
        o["nu"] = jax.tree.map(lambda x: ((1e-2 * rng.normal(size=x.shape)) ** 2 + 1e-6)
                               .astype(np.float32), o["nu"])
        o["count"] = 10
    start["step"] = 10

    key, batch = jax.random.PRNGKey(9), _batch(4, 4)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        jnew, jinfo = jax_with_state(jagent, start, key).update_high_utd(_jb(batch), utd_ratio=1)
    assert len(masks) == 2 * (len(CRITIC_PASSES) + len(ACTOR_PASSES))

    offsets, rng_key = jax_augment_draws(key, 4)
    updates = jax_high_utd_draws(rng_key, 4, 1, ensemble=E, subsample=S, action_dim=ACT)
    recorded = iter(masks)
    for draws, passes in zip(updates, (CRITIC_PASSES, ACTOR_PASSES)):
        for name in passes:
            draws[f"{name}_dropout"] = {k: next(recorded) for k in KEYS}
    agent = DrQAgent.create_drq(_tb(_example()), torch.zeros(1, ACT),
                                generator=torch.Generator().manual_seed(1), device="cpu",
                                **_kwargs(), **port_encs)
    assert agent.encoder.encoders["front"].compute_dtype == getattr(torch, dtype)
    load_train_state(agent, start)
    _, info = agent.update_high_utd(_tb(batch), utd_ratio=1,
                                    draws={"augment": offsets, "updates": updates})
    got, want = train_state_to_jax_layout(agent), jax_state_np(jnew)
    atol, mu_atol, rtol, min_cos = TOL[dtype]
    for part in ("params", "target_params"):
        assert_trees_close(got[part], want[part], atol, what=part)
    assert got["step"] == want["step"]
    for g, o in want["opt_states"].items():
        p = got["opt_states"][g]
        assert p["count"] == o["count"]
        assert_trees_close(p["mu"], o["mu"], mu_atol, rtol=1e-5, what=f"{g} mu")
        assert_trees_close(p["nu"], o["nu"], mu_atol ** 2, rtol=1e-4, what=f"{g} nu")
    for g in ("critic", "actor", "temperature"):
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=rtol, atol=1e-7,
                                       err_msg=f"{g} {k}")
    # the backbones trained in both, by the same steps
    jax_steps, port_steps = _backbone_steps(start, want), _backbone_steps(start, got)
    assert len(jax_steps) == 2 * 36  # conv_init, norm_init, 4 blocks (3 projected) a camera
    for name, (b, a) in jax_steps.items():
        step, port = (a - b).ravel(), (port_steps[name][1] - b).ravel()
        assert np.abs(step).max() > 0 and np.abs(port).max() > 0, name
        cos = float(step @ port / (np.linalg.norm(step) * np.linalg.norm(port)))
        assert cos >= min_cos, (name, cos)
