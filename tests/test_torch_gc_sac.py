"""SAC updates through the goal- and language-conditioned encoders against
serl_tpu's, on the CPU.

One `update_high_utd` (UTD 2, batch 4) of a SAC agent (critic and policy
width 32, a 4-member critic subsampled to 2) through a GC encoder (early
fusion with proprio, late fusion) and an LC encoder (a FiLM ResNet) of
tests/test_torch_gc_encoders.py, from the same mid-run learner state (the
params perturbed, so FiLM's Dense layers are nonzero; the target apart;
Adam moments of a training run's scale, count 10) with every draw JAX's own
(tests/test_torch_learner.py): params, targets and Adam moments within 2e-6
abs, as tests/test_torch_learner.py holds update_high_utd; the infos to
1e-5 relative. Then acting on (obs, goal) pairs: deterministic, and a
different goal gives different actions. `update_parity` serves
tests/test_torch_mobilenet.py too.
"""

import flax.linen.stochastic as stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.utils.jax_params import load_train_state, train_state_to_jax_layout
from tests.test_torch_gc_encoders import ENCODERS, _pairs_obs, _to
from tests.test_torch_learner import (
    assert_states_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)

HID, E, S, ACT = 32, 4, 2, 4
OPT = {"learning_rate": 1e-3}
CRITIC_PASSES = ("critic_next", "target", "critic")
ACTOR_PASSES = ("actor", "actor_critic", "temperature_next")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def recording_dropout_jit(monkeypatch):
    """Every dropout keep-mask flax draws, in program order, from a jitted
    JAX run: each mask goes to the host through an ordered debug callback
    (tests/test_torch_resnet.py's recorder needs an eager run, which takes
    tens of seconds for a whole update through a MobileNet)."""
    masks = []
    real = stochastic.random

    class Recorder:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def bernoulli(key, p, shape):
            mask = real.bernoulli(key, p=p, shape=shape)
            jax.debug.callback(lambda m: masks.append(torch.from_numpy(np.array(m))), mask,
                               ordered=True)
            return mask

    monkeypatch.setattr(stochastic, "random", Recorder())
    return masks


def _kwargs():
    net = {"activations": "tanh", "use_layer_norm": True, "hidden_dims": (HID, HID)}
    return dict(policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp",
                               "std_min": 1e-5, "std_max": 5.0},
                critic_network_kwargs=net, policy_network_kwargs=dict(net), temperature_init=1e-2,
                discount=0.96, critic_ensemble_size=E, critic_subsample_size=S,
                actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                temperature_optimizer_kwargs=OPT)


def mid_run_start(jagent, frozen=lambda path: False, seed=0):
    """The JAX agent's learner state with its params perturbed (the target
    critic apart from them) and Adam moments of a training run's scale,
    count 10 (from zero moments Adam's first step is ill-conditioned:
    tests/test_torch_resnet_drq.py); leaves where `frozen(path)` stay."""
    rng = np.random.default_rng(seed)

    def perturb(tree, scale):
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.asarray(x) if frozen(p)
            else (np.asarray(x) + scale * rng.normal(size=x.shape)).astype(np.float32), tree)

    def moments(tree, scale, square):
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.zeros_like(x) if frozen(p)
            else ((scale * rng.normal(size=x.shape)) ** (1 + square) + 1e-6 * square)
            .astype(np.float32), tree)

    params = perturb(jax.device_get(jagent.state.params), 0.1)
    start = jax_state_np(jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params),
        target_params=jax.tree.map(jnp.asarray, perturb({"critic": params["critic"]}, 0.05)))))
    for o in start["opt_states"].values():
        o["mu"], o["nu"], o["count"] = moments(o["mu"], 1e-3, 0), moments(o["nu"], 1e-2, 1), 10
    start["step"] = 10
    return start


def update_parity(jencoder, encoder, example, batch, monkeypatch, utd=2, masks_per_pass=0,
                  frozen=lambda path: False, atol=2e-6):
    """One update_high_utd through `jencoder` (flax) and `encoder` (the port)
    from one mid-run state with JAX's draws (dropout keep-masks recorded from
    flax when `masks_per_pass`); returns (port agent, its state, JAX's)."""
    jagent = JaxSACAgent.create_pixels(jax.random.PRNGKey(0), _to(example, jnp.asarray),
                                       jnp.zeros((1, ACT)), encoder_def=jencoder, **_kwargs())
    start = mid_run_start(jagent, frozen)
    key = jax.random.PRNGKey(9)
    n = batch["rewards"].shape[0]
    masks = recording_dropout_jit(monkeypatch)
    jnew, jinfo = jax_with_state(jagent, start, key).update_high_utd(_to(batch, jnp.asarray),
                                                                     utd_ratio=utd)
    jax.effects_barrier()
    assert len(masks) == masks_per_pass * (utd * len(CRITIC_PASSES) + len(ACTOR_PASSES))
    updates = jax_high_utd_draws(key, n, utd, ensemble=E, subsample=S, action_dim=ACT)
    if masks_per_pass:
        recorded = iter(masks)
        for i, draws in enumerate(updates):
            for name in (CRITIC_PASSES if i < utd else ACTOR_PASSES):
                draws[f"{name}_dropout"] = {k: next(recorded) for k in ["encoder"]}
    agent = SACAgent.create_pixels(_to(example, torch.from_numpy), torch.zeros(1, ACT),
                                   encoder=encoder, generator=torch.Generator().manual_seed(1),
                                   device="cpu", **_kwargs())
    load_train_state(agent, start)
    _, info = agent.update_high_utd(_to(batch, torch.from_numpy), utd_ratio=utd,
                                    draws=updates)
    got, want = train_state_to_jax_layout(agent), jax_state_np(jnew)
    assert_states_close(got, want, atol=atol)
    for g in ("critic", "actor", "temperature"):
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{g} {k}")
    return agent, got, start


def gc_batch(name, n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": _pairs_obs(name, n, seed), "next_observations": _pairs_obs(name, n, seed + 7),
            "actions": rng.uniform(-0.95, 0.95, (n, ACT)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": (rng.uniform(size=(n,)) > 0.2).astype(np.float32),
            "dones": np.zeros((n,), np.float32)}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_torch_sac_update_through_gc_lc_encoders_matches_jax(name, monkeypatch):
    jfac, tfac, _ = ENCODERS[name]
    example = _to(_pairs_obs(name, 1, 0), lambda v: v)
    agent, _, _ = update_parity(jfac(), tfac(), example, gc_batch(name, 4, 30), monkeypatch)
    # acting on (obs, goal) pairs: deterministic, and the goal matters
    obs, goal = _to(_pairs_obs(name, 3, 40), torch.from_numpy)
    a = agent.sample_actions((obs, goal), argmax=True)
    assert tuple(a.shape) == (3, ACT) and torch.equal(a, agent.sample_actions((obs, goal),
                                                                              argmax=True))
    other = _to(_pairs_obs(name, 3, 50), torch.from_numpy)[1]
    assert not torch.equal(a, agent.sample_actions((obs, other), argmax=True))
