"""The port's DrQ learner against serl_tpu's, on the CPU.

Small DrQ agents (two cameras at 32 px through narrow float32 SmallEncoders
given as `custom_encoders`, features (4, 8, 8, 16), bottleneck 16; 7-dim
proprio; LayerNorm-tanh MLPs of width 32; a 4-member critic subsampled to 2)
are built by both packages. The JAX agent's params, perturbed, with the
target critic (target encoder included) apart from them, and its learner
state after two update_high_utd calls are carried into the port through
`utils/jax_params.py`. Every random draw the port reads is JAX's own,
replayed from the key splits: DrQ's crop offsets per image key for obs and
next_obs (drq.py:145, 127, 112; augmentations.py:72), then SAC's action
noise and subsample indices (tests/test_torch_learner.py).

Tolerances, float32 throughout (the encoders' convolutions sum in another
order than XLA's): losses 1e-5 relative; per-group gradients 2e-5 abs +
1e-4 relative; post-update learner states as in test_torch_learner.py
(2e-6 abs after two minibatch and one full-batch Adam steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.utils.jax_params import group_tree, load_train_state, train_state_to_jax_layout
from serl_tpu_torch.vision.encoders import SmallEncoder
from tests.test_torch_learner import (
    assert_states_close,
    assert_trees_close,
    jax_high_utd_draws,
    jax_loss_draws,
    jax_state_np,
    jax_with_state,
)

KEYS = ("front", "wrist")
FEATURES, BOTTLENECK, H, E, S, ACT, SIZE = (4, 8, 8, 16), 16, 32, 4, 2, 4, 32
OPT = {"learning_rate": 1e-3}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kwargs(tanh):
    net = {"activations": tanh, "use_layer_norm": True, "hidden_dims": (H, H)}
    return dict(image_keys=KEYS, policy_kwargs={"tanh_squash_distribution": True,
                                                "std_parameterization": "exp",
                                                "std_min": 1e-5, "std_max": 5.0},
                critic_network_kwargs=net, policy_network_kwargs=dict(net), temperature_init=1e-2,
                discount=0.96, critic_ensemble_size=E, critic_subsample_size=S,
                actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                temperature_optimizer_kwargs=OPT)


def _obs(rng, n):
    return {"state": rng.normal(size=(n, 7)).astype(np.float32),
            **{k: rng.integers(0, 256, (n, 1, SIZE, SIZE, 3)).astype(np.uint8) for k in KEYS}}


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": _obs(rng, n), "next_observations": _obs(rng, n),
            "actions": rng.uniform(-0.95, 0.95, (n, ACT)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": (rng.uniform(size=(n,)) > 0.2).astype(np.float32),
            "dones": np.zeros((n,), np.float32)}


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _jb(batch):
    return _tree(jnp.asarray, batch)


def _tb(batch):
    return _tree(torch.from_numpy, batch)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def jax_augment_draws(key, batch_size):
    """DrQ.update_high_utd's crop offsets from the agent's key, and the key
    its SAC update then reads."""
    rng, aug_rng = jax.random.split(key)
    _, k_obs, k_next = jax.random.split(aug_rng, 3)
    offsets = {}
    for part, r in (("observations", k_obs), ("next_observations", k_next)):
        offsets[part] = {}
        for k in KEYS:
            r, kk = jax.random.split(r)
            offsets[part][k] = torch.from_numpy(
                np.array(jax.random.randint(kk, (batch_size, 2), 0, 9))).long()
    return offsets, rng


@pytest.fixture(scope="module")
def start():
    """A JAX DrQ agent (perturbed params, target apart), its learner state
    after two update_high_utd calls, and the port agent."""
    encs = {k: JaxSmallEncoder(features=FEATURES, bottleneck_dim=BOTTLENECK,
                               compute_dtype=jnp.float32, name=f"encoder_{k}") for k in KEYS}
    example = _tree(lambda x: x[:1], _batch(1, 0)["observations"])
    jagent = JaxDrQAgent.create_drq(jax.random.PRNGKey(0), _jb(example), jnp.zeros((1, ACT)),
                                    custom_encoders=encs, **_kwargs(jnp.tanh))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
                          _np(jagent.state.params))
    target = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                          {"critic": params["critic"]})
    jagent = jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target)))
    mid = jagent
    for i in range(2):
        mid, _ = mid.update_high_utd(_jb(_batch(8, 10 + i)), utd_ratio=2)
    tencs = {k: SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK) for k in KEYS}
    tagent = DrQAgent.create_drq(_tb(example), torch.zeros(1, ACT), custom_encoders=tencs,
                                 generator=torch.Generator().manual_seed(1), device="cpu",
                                 **_kwargs("tanh"))
    return jagent, jax_state_np(mid), tagent


def test_torch_drq_losses_and_group_grads_match_jax(start):
    """The three losses on an augmented batch, each differentiated w.r.t.
    its own group (the critic group holds the encoders); the actor loss
    leaves every encoder gradient zero."""
    jagent, mid, tagent = start
    load_train_state(tagent, mid)
    jagent = jax_with_state(jagent, mid, jax.random.PRNGKey(0))
    batch = _batch(8, 1)
    offsets, _ = jax_augment_draws(jax.random.PRNGKey(4), 8)
    tbatch = tagent._augment_batch(_tb(batch), offsets)
    jbatch = _tree(lambda x: jnp.asarray(x.numpy()), tbatch)  # the same crops for JAX
    params = jagent.state.params
    keys = dict(zip(("actor", "critic", "temperature"), jax.random.split(jax.random.PRNGKey(5), 3)))
    jfns = {"critic": jagent.critic_loss_fn, "actor": jagent.policy_loss_fn,
            "temperature": jagent.temperature_loss_fn}
    tfns = {"critic": tagent.critic_loss_fn, "actor": tagent.policy_loss_fn,
            "temperature": tagent.temperature_loss_fn}
    for g in ("critic", "actor", "temperature"):
        (jloss, _), jgrad = jax.jit(jax.value_and_grad(
            lambda p: jfns[g](jbatch, {**params, g: p}, keys[g]), has_aux=True))(params[g])
        loss, _ = tfns[g](tbatch, jax_loss_draws(keys[g], g, 8, ensemble=E, action_dim=ACT))
        grads = torch.autograd.grad(loss, tagent.state.params[g], allow_unused=True,
                                    materialize_grads=True)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=g)
        assert_trees_close(group_tree(tagent, g, grads), _np(jgrad), atol=2e-5, rtol=1e-4,
                           what=f"{g} grad ")
    # the actor loss puts no gradient into the critic group (encoders included)
    loss, _ = tagent.policy_loss_fn(tbatch, jax_loss_draws(keys["actor"], "actor", 8,
                                                           ensemble=E, action_dim=ACT))
    enc_grads = torch.autograd.grad(loss, tagent.state.params["critic"], allow_unused=True,
                                    materialize_grads=True)
    assert all(bool((gr == 0).all()) for gr in enc_grads)
    enc = group_tree(tagent, "critic", enc_grads)["encoder"]
    assert set(enc) == {"encoders_front", "encoders_wrist", "Dense_0", "LayerNorm_0"}


def test_torch_drq_update_high_utd_matches_jax(start):
    jagent, mid, tagent = start
    key = jax.random.PRNGKey(9)
    load_train_state(tagent, mid)
    batch = _batch(8, 4)
    jnew, jinfo = jax_with_state(jagent, mid, key).update_high_utd(_jb(batch), utd_ratio=2)
    offsets, rng = jax_augment_draws(key, 8)
    draws = {"augment": offsets,
             "updates": jax_high_utd_draws(rng, 8, 2, ensemble=E, subsample=S, action_dim=ACT)}
    _, info = tagent.update_high_utd(_tb(batch), utd_ratio=2, draws=draws)
    got, want = train_state_to_jax_layout(tagent), jax_state_np(jnew)
    assert_states_close(got, want, atol=2e-6)
    # the update moved the encoders and their targets
    for part in ("params", "target_params"):
        moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                             want[part]["critic"]["encoder"], mid[part]["critic"]["encoder"])
        assert min(jax.tree.leaves(moved)) > 0, part
    for g in ("critic", "actor", "temperature"):
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{g} {k}")


def test_torch_drq_augment_crops_each_part_and_key_apart():
    """One K3 call crops obs and next_obs of every key, each with its own
    offsets; `augment=False` leaves the batch as it is."""
    agent = DrQAgent.create_drq(
        _tb(_tree(lambda x: x[:1], _batch(1, 0)["observations"])), torch.zeros(1, ACT),
        custom_encoders={k: SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK) for k in KEYS},
        generator=torch.Generator().manual_seed(0), device="cpu", **_kwargs("tanh"))
    batch = _tb(_batch(6, 2))
    batch["next_observations"] = _tree(torch.clone, batch["observations"])
    offsets = agent.augment_draws(batch, torch.Generator().manual_seed(3))
    out = agent._augment_batch(batch, offsets)
    for k in KEYS:
        assert out["observations"][k].shape == (6, 1, SIZE, SIZE, 3)
        assert not torch.equal(out["observations"][k], out["next_observations"][k])
    torch.testing.assert_close(out["observations"]["state"], batch["observations"]["state"])
    agent.config = agent.config._replace(augment=False)
    assert agent._augment_batch(batch, {}) is batch
