"""The agent updates the loops do not call, against serl_tpu's, on the CPU.

- `DrQAgent.update_critics`: tests/test_torch_drq.py's small DrQ agent with
  JAX's mid-run learner state grafted in; one critic-only update of an
  augmented batch with JAX's draws (the crop offsets, then the critic's
  noise and subsample): every group's params, targets and Adam moments
  (the other groups step with zero gradients) to 2e-6 abs, the critic loss
  to 1e-5 relative.
- `VICEAgent.update_critics`: tests/test_torch_vice.py's agents, the same
  update with the rewards from the VICE classifier: states to 5e-6 abs.
- BC through an image encoder (`BCAgent.create(image_keys=...)`, both
  packages' registries giving narrow float32 SmallEncoders): JAX's params,
  perturbed, and its learner state after two updates carried into the
  port; one update (actor_loss and mse 1e-5 relative; the actor's params
  and moments 2e-6 abs; the encoder untouched), the mode on the same
  observations (1e-5 abs), and the full-width "small" encoder built by the
  port's own registry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents import bc as jbc
from serl_tpu.agents import drq as jdrq
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu_torch.agents import drq
from serl_tpu_torch.agents.bc import BCAgent
from serl_tpu_torch.utils.jax_params import (
    _encoder_pairs,
    actor_pairs,
    load_pairs,
    load_train_state,
    pairs_to_tree,
    train_state_to_jax_layout,
)
from serl_tpu_torch.vision.encoders import SmallEncoder
from tests.test_torch_drq import ACT, BOTTLENECK, E, FEATURES, S, _batch, _jb, _tb, _tree
from tests.test_torch_drq import jax_augment_draws, start  # noqa: F401  (the fixture)
from tests.test_torch_learner import (
    assert_states_close,
    jax_state_np,
    jax_update_draws,
    jax_with_state,
)
from tests.test_torch_vice import _agents, vice_update_draws


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_torch_drq_update_critics_matches_jax(start):  # noqa: F811
    jagent, mid, tagent = start
    load_train_state(tagent, mid)
    key = jax.random.PRNGKey(21)
    batch = _batch(8, 5)
    jnew, jinfo = jax_with_state(jagent, mid, key).update_critics(_jb(batch))
    offsets, rng = jax_augment_draws(key, 8)
    update, _ = jax_update_draws(rng, 8, {"critic"}, ensemble=E, subsample=S, action_dim=ACT)
    _, info = tagent.update_critics(_tb(batch), draws={"augment": offsets, "update": update})
    assert "actor" not in info and "temperature" not in info
    np.testing.assert_allclose(float(info["critic"]["critic_loss"]),
                               float(jinfo["critic"]["critic_loss"]), rtol=1e-5)
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jnew), atol=2e-6)
    drawn = tagent.critic_draws(_tb(batch), torch.Generator().manual_seed(0))
    assert set(drawn) == {"augment", "update"} and set(drawn["update"]) == set(update)


def test_torch_vice_update_critics_matches_jax(monkeypatch):
    jagent, mid, tagent = _agents(monkeypatch)
    load_train_state(tagent, mid)
    key = jax.random.PRNGKey(22)
    batch = _batch(8, 6)
    jnew, jinfo = jax_with_state(jagent, mid, key).update_critics(_jb(batch))
    offsets, rng = jax_augment_draws(key, 8)
    update, _ = vice_update_draws(rng, 8, {"critic"})
    _, info = tagent.update_critics(_tb(batch), draws={"augment": offsets, "update": update})
    np.testing.assert_allclose(float(info["critic"]["critic_loss"]),
                               float(jinfo["critic"]["critic_loss"]), rtol=1e-5)
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jnew), atol=5e-6)


# ---------------------------------------------------------------- BC with an image encoder

OBS_KEYS, SIZE, BC_ACT, H = ("front",), 32, 4, 64
NET = {"hidden_dims": (H,)}


def _narrow(monkeypatch):
    monkeypatch.setattr(jdrq, "make_image_encoders", lambda et, keys, shared=False: {
        k: JaxSmallEncoder(features=FEATURES, bottleneck_dim=BOTTLENECK,
                           compute_dtype=jnp.float32, name=f"encoder_{k}") for k in keys})
    monkeypatch.setattr(drq, "make_image_encoders", lambda et, keys, generator=None, **kw: {
        k: SmallEncoder(kw.get("in_channels", 3), FEATURES, bottleneck_dim=BOTTLENECK,
                        generator=generator) for k in keys})


def _bc_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": {"state": rng.normal(size=(n, 7)).astype(np.float32),
                             "front": rng.integers(0, 256, (n, 1, SIZE, SIZE, 3)).astype(np.uint8)},
            "actions": rng.uniform(-1, 1, (n, BC_ACT)).astype(np.float32)}


def _load_bc(agent, state):
    """A JAX BC learner state (params: actor and encoder) into the port."""
    load_pairs(_encoder_pairs(agent.encoder, root=("encoder",)), state["params"])
    pairs = actor_pairs(agent.actor)
    load_pairs(pairs, state["params"])
    index = {id(p): i for i, p in enumerate(agent.state.params["actor"])}
    opt, src = agent.state.opt_states["actor"], state["opt_states"]["actor"]
    for tree, target in ((src["mu"], opt.mu), (src["nu"], opt.nu)):
        load_pairs([(path[1:], target[index[id(t)]], layout) for path, t, layout in pairs], tree)
    opt.count, opt.learning_rate = src["count"], src["learning_rate"]


def test_torch_bc_with_an_image_encoder_matches_jax(monkeypatch):
    _narrow(monkeypatch)
    example = _bc_batch(2, 0)
    jagent = jbc.BCAgent.create(jax.random.PRNGKey(0), _tree(jnp.asarray, example["observations"]),
                                jnp.zeros((2, BC_ACT)), encoder_type="small", image_keys=OBS_KEYS,
                                use_proprio=True, network_kwargs=NET)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape))
                          .astype(np.float32), jax.device_get(jagent.state.params))
    jagent = jagent.replace(state=jagent.state.replace(params=jax.tree.map(jnp.asarray, params)))
    for i in range(2):
        jagent, _ = jagent.update(_tree(jnp.asarray, _bc_batch(8, 10 + i)))
    agent = BCAgent.create(_tree(torch.from_numpy, example["observations"]),
                           torch.zeros(2, BC_ACT), image_keys=OBS_KEYS, use_proprio=True,
                           network_kwargs=NET, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    _load_bc(agent, jax_state_np(jagent))
    encoder_before = [p.detach().clone() for p in agent.encoder.parameters()]
    batch = _bc_batch(8, 3)
    obs = _tree(torch.from_numpy, batch["observations"])
    np.testing.assert_allclose(agent.sample_actions(obs, argmax=True).numpy(),
                               np.asarray(jagent.sample_actions(_tree(jnp.asarray,
                                                                      batch["observations"]),
                                                                argmax=True)),
                               atol=1e-5, rtol=0)
    jnew, jinfo = jagent.update(_tree(jnp.asarray, batch))
    _, info = agent.update(_tree(torch.from_numpy, batch))
    for k in ("actor_loss", "mse"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]), rtol=1e-5, err_msg=k)
    got = pairs_to_tree(actor_pairs(agent.actor))
    want = jax_state_np(jnew)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=2e-6, rtol=0), got["actor"],
                 want["params"]["actor"])
    mu = want["opt_states"]["actor"]["mu"]
    index = {id(p): i for i, p in enumerate(agent.state.params["actor"])}
    for path, t, layout in actor_pairs(agent.actor):
        node = mu
        for key_ in path[1:]:
            node = node[key_]
        value = agent.state.opt_states["actor"].mu[index[id(t)]]
        value = value.T if layout == "T" else value
        np.testing.assert_allclose(value.numpy(), node, atol=2e-6, rtol=1e-5)
    # the encoder has no optimizer and no gradient: untouched, as in JAX
    assert all(torch.equal(a, b) for a, b in zip(agent.encoder.parameters(), encoder_before))
    np.testing.assert_array_equal(want["params"]["encoder"]["Dense_0"]["kernel"],
                                  jax_state_np(jagent)["params"]["encoder"]["Dense_0"]["kernel"])


def test_torch_bc_image_encoder_from_the_registry():
    obs = _tree(torch.from_numpy, _bc_batch(2, 0)["observations"])
    agent = BCAgent.create(obs, torch.zeros(2, BC_ACT), image_keys=OBS_KEYS, use_proprio=True,
                           device="cpu")
    enc = agent.encoder.encoders["front"]
    assert enc.compute_dtype == torch.bfloat16 and enc.out_features == 256
    assert agent.actor.trunk.dense[0].in_features == 256 + 64
    _, info = agent.update({"observations": obs, "actions": torch.zeros(2, BC_ACT)})
    assert np.isfinite(float(info["actor_loss"]))
