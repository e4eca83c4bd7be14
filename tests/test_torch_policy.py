"""The port's SAC networks and acting against serl_tpu's, on the CPU.

The JAX agent is built by serl_tpu's launcher at full width (256x256
LayerNorm-tanh MLPs, a 10-member critic ensemble); its params go to numpy
and into the port's agent through `load_sac_params`. Forward passes agree to
2e-5 abs (float32 products of 256-wide layers summed in another order, then
two LayerNorms), fed-noise samples and log-probs to 1e-4 (tanh and atanh of
those means, near +-1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.common.distributions import TanhNormal as JTanhNormal
from serl_tpu.networks.mlp import EnsembleMLP as JEnsembleMLP
from serl_tpu.training.launcher import make_sac_agent as jax_make_sac_agent
from serl_tpu_torch.common.distributions import TanhNormal
from serl_tpu_torch.networks.lagrange import init_lagrange_params, lagrange_value
from serl_tpu_torch.networks.mlp import LAYER_NORM_EPS, EnsembleMLP
from serl_tpu_torch.training.launcher import make_sac_agent
from serl_tpu_torch.utils.jax_params import load_sac_params, to_jax_layout

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def agents():
    jagent = jax_make_sac_agent(0)
    params = jax.tree.map(np.asarray, jax.device_get(jagent.state.params))
    # perturb every LayerNorm and bias away from its init so the comparison
    # sees them (at init they are 1 and 0 and would hide a layout fault)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32), params)
    jagent = jagent.replace(state=jagent.state.replace(params=jax.tree.map(jnp.asarray, params)))
    tagent = make_sac_agent(1, device="cpu")  # another seed: every weight is overwritten
    load_sac_params(tagent, params)
    return jagent, tagent, params


def _obs(n=64, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 10)).astype(np.float32)


def test_torch_policy_and_critic_match_jax_at_full_width(agents):
    jagent, tagent, _ = agents
    obs = _obs()
    acts = np.random.default_rng(2).uniform(-0.99, 0.99, (64, 4)).astype(np.float32)
    jd = jagent.forward_policy(jnp.asarray(obs), train=False)
    td = tagent.forward_policy(torch.from_numpy(obs))
    np.testing.assert_allclose(td.loc.detach().numpy(), np.asarray(jd.loc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.scale.detach().numpy(), np.asarray(jd.scale), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(td.mode().detach().numpy(), np.asarray(jd.mode()), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td.log_prob(torch.from_numpy(acts)).detach().numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(acts))), atol=1e-4, rtol=1e-5)
    jq = jagent.forward_critic(jnp.asarray(obs), jnp.asarray(acts), train=False)
    tq = tagent.forward_critic(torch.from_numpy(obs), torch.from_numpy(acts))
    assert tq.shape == jq.shape == (10, 64)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tagent.temperature().item(), float(jagent.temperature()), rtol=1e-6)


def test_torch_sample_actions_with_fed_noise_matches_jax(agents):
    """JAX draws eps = jax.random.normal(key, loc.shape) inside sample; the
    port is fed that same eps."""
    jagent, tagent, _ = agents
    obs = _obs(32, 3)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, (32, 4), jnp.float32))
    want = jagent.sample_actions(jnp.asarray(obs), seed=key, temperature=0.5)
    got = tagent.sample_actions(torch.from_numpy(obs), noise=torch.from_numpy(eps), temperature=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    greedy = tagent.sample_actions(torch.from_numpy(obs), argmax=True)
    np.testing.assert_allclose(greedy.numpy(), np.asarray(jagent.sample_actions(
        jnp.asarray(obs), argmax=True)), atol=ATOL, rtol=0)
    jd = jagent.forward_policy(jnp.asarray(obs), train=False)
    jx, jlp = JTanhNormal(jd.loc, jd.scale).sample_and_log_prob(key)
    tdist = TanhNormal(torch.tensor(np.asarray(jd.loc)), torch.tensor(np.asarray(jd.scale)))
    x, lp = tdist.sample_and_log_prob(eps=torch.from_numpy(eps))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=1e-5)


def test_torch_std_is_clipped_before_sqrt_temperature():
    agent = make_sac_agent(0, device="cpu")
    with torch.no_grad():
        agent.actor.std_head.bias.fill_(10.0)  # exp(10 + ...) far above std_max = 5
    with torch.no_grad():
        d = agent.forward_policy(torch.zeros(3, 10), temperature=0.25)
    np.testing.assert_allclose(d.scale.numpy(), np.full((3, 4), 5.0 * 0.5), rtol=1e-6)
    np.testing.assert_array_equal(d.mode().numpy(), torch.tanh(d.loc).numpy())


def test_torch_sac_params_round_trip(agents):
    _, tagent, params = agents
    back = to_jax_layout(tagent)
    flat_in = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    other = make_sac_agent(2, device="cpu")
    load_sac_params(other, back)
    for a, b in zip(other.parameters(), tagent.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_torch_layer_norm_eps_is_flax_default():
    """flax LayerNorm eps is 1e-6; torch's default 1e-5 would move features
    of low-variance inputs (here variance ~1e-5) by ~30%."""
    agent = make_sac_agent(0, device="cpu")
    norms = list(agent.actor.trunk.norms) + list(agent.critic.trunk.norms)
    assert norms and all(n.eps == LAYER_NORM_EPS == 1e-6 for n in norms)
    x = np.random.default_rng(5).normal(0.0, 3e-3, (4, 256)).astype(np.float32)
    import flax.linen as fnn

    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(256), "bias": jnp.zeros(256)}},
                                 jnp.asarray(x))
    got = norms[0](torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    wrong = torch.nn.functional.layer_norm(torch.from_numpy(x), (256,), eps=1e-5).numpy()
    assert np.abs(wrong - np.asarray(want)).max() > 0.1


def test_torch_ensemble_mlp_shares_one_layer_norm():
    """One LayerNorm per layer serves all members: with member-specific
    kernels, only shared normalization params reproduce the JAX outputs."""
    E, B, d_in = 3, 5, 7
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    jnet = JEnsembleMLP(E, (16, 16), activations=jnp.tanh, activate_final=True, use_layer_norm=True)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jparams = jax.tree.map(lambda p: jnp.asarray(p + 0.2 * rng.normal(size=p.shape), jnp.float32), jparams)
    assert jparams["LayerNorm_0"]["scale"].shape == (16,)  # shared, not (E, 16)
    tnet = EnsembleMLP(E, d_in, (16, 16), activations="tanh", activate_final=True,
                       use_layer_norm=True)
    with torch.no_grad():
        for i in range(2):
            tnet.dense[i].kernel.copy_(torch.from_numpy(np.asarray(jparams[f"EnsembleDense_{i}"]["kernel"])))
            tnet.dense[i].bias.copy_(torch.from_numpy(np.asarray(jparams[f"EnsembleDense_{i}"]["bias"])))
            tnet.norms[i].weight.copy_(torch.from_numpy(np.asarray(jparams[f"LayerNorm_{i}"]["scale"])))
            tnet.norms[i].bias.copy_(torch.from_numpy(np.asarray(jparams[f"LayerNorm_{i}"]["bias"])))
    assert len(tnet.norms) == 2 and tnet.norms[0].weight.shape == (16,)
    got = tnet(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(x)))
    assert got.shape == want.shape == (E, B, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_torch_lagrange_matches_jax():
    from serl_tpu.networks.lagrange import init_lagrange_params as jinit
    from serl_tpu.networks.lagrange import lagrange_value as jvalue

    for param in ("softplus", "exp"):
        p, jp = init_lagrange_params(0.01, (), param), jinit(0.01, (), param)
        np.testing.assert_allclose(p["raw"].numpy(), np.asarray(jp["raw"]), rtol=1e-6)
        np.testing.assert_allclose(lagrange_value(p, param).numpy(), np.asarray(jvalue(jp, param)),
                                   rtol=1e-6)
