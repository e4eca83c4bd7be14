"""The port's network families against serl_tpu's, on the CPU.

MLP (dropout in flax's order), MLPResNet, the policy's and the critic's
dropout and `init_final`, the critic's (B, A, action) batches, ValueCritic,
DistributionalCriticNet, ContrastiveCritic and TanhNormal's [low, high]
rescale, each built by both packages at narrow widths; flax's params,
perturbed away from init (zero biases, LayerNorm scales of one), are
carried into the port through `utils/jax_params.py`. Dropout keep-masks
are recorded from flax as JAX runs eagerly (tests/test_torch_resnet.py's
`recording_dropout`) and fed to the port in layer order.

Tolerance: 1e-5 abs on every output and gradient (float32 sums of at most
a few hundred terms taken in another order; measured below 2e-6), and
exact where both sides only select (the atoms, the dropout's zeros).
The planted fault this file catches: the contrastive critic's halves
swapped (obs features into the goal tower).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.common.distributions import TanhNormal as JaxTanhNormal
from serl_tpu.networks import actor_critic as jac
from serl_tpu.networks import mlp as jmlp
from serl_tpu_torch.common.distributions import TanhNormal
from serl_tpu_torch.networks import actor_critic as tac
from serl_tpu_torch.networks import mlp as tmlp
from serl_tpu_torch.utils.jax_params import (
    actor_pairs,
    critic_family_pairs,
    ensemble_mlp_pairs,
    load_pairs,
    mlp_pairs,
)
from tests.test_torch_resnet import recording_dropout

ATOL = 1e-5
B, F, A = 6, 10, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + scale * rng.normal(size=np.shape(x)))
                        .astype(np.float32), jax.device_get(params))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("act,layer_norm", [("swish", False), ("tanh", True), ("swish", True)])
def test_torch_mlp_dropout_matches_flax(act, layer_norm, monkeypatch):
    """Dense -> Dropout -> LayerNorm -> act per layer in train mode, with
    flax's masks; without train, no dropout (and LayerNorm + tanh via K5)."""
    x, = _inputs(0, (B, F))
    jnet = jmlp.MLP(hidden_dims=(16, 16, 8), activations=getattr(fnn, act),
                    activate_final=False, use_layer_norm=layer_norm, dropout_rate=0.3)
    params = _perturbed(jnet.init(jax.random.PRNGKey(0), x)["params"], 1)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jnet.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
    net = tmlp.MLP(F, (16, 16, 8), act, activate_final=False, use_layer_norm=layer_norm,
                   dropout_rate=0.3)
    load_pairs(mlp_pairs(net), params)
    assert [tuple(m.shape) for m in masks] == [(B, 16), (B, 16)]
    tx = torch.from_numpy(x)
    _close(net(tx, train=True, dropout=masks), want)
    _close(net(tx), jnet.apply({"params": params}, x))
    assert not torch.allclose(net(tx), net(tx, train=True, dropout=masks))
    with pytest.raises(ValueError, match="keep-mask"):
        net(tx, train=True)


def test_torch_ensemble_mlp_dropout_matches_flax(monkeypatch):
    x, = _inputs(1, (B, F))
    jnet = jmlp.EnsembleMLP(ensemble_size=3, hidden_dims=(16, 8), activations=fnn.tanh,
                            activate_final=True, use_layer_norm=True, dropout_rate=0.2)
    params = _perturbed(jnet.init(jax.random.PRNGKey(1), x)["params"], 2)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jnet.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(3)})
    net = tmlp.EnsembleMLP(3, F, (16, 8), "tanh", activate_final=True, use_layer_norm=True,
                           dropout_rate=0.2)
    load_pairs(ensemble_mlp_pairs(net), params)
    assert [tuple(m.shape) for m in masks] == [(3, B, 16), (3, B, 8)]
    _close(net(torch.from_numpy(x), train=True, dropout=masks), want)
    _close(net(torch.from_numpy(x)), jnet.apply({"params": params}, x))


@pytest.mark.parametrize("layer_norm,dropout", [(False, None), (True, 0.1)])
def test_torch_mlp_resnet_matches_flax(layer_norm, dropout, monkeypatch):
    """MLPResNet forward (train mode with flax's masks where it has dropout)
    and its input gradient."""
    x, dy = _inputs(2, (B, F), (B, 5))
    jnet = jmlp.MLPResNet(num_blocks=3, out_dim=5, hidden_dim=16, use_layer_norm=layer_norm,
                          dropout_rate=dropout)
    params = _perturbed(jnet.init(jax.random.PRNGKey(2), x)["params"], 3)
    masks = recording_dropout(monkeypatch)
    rngs = {"dropout": jax.random.PRNGKey(4)}
    with jax.disable_jit():
        want, vjp = jax.vjp(lambda xx: jnet.apply({"params": params}, xx, train=True, rngs=rngs), x)
        want_dx, = vjp(dy)
    net = tmlp.MLPResNet(F, 3, 5, dropout_rate=dropout, use_layer_norm=layer_norm, hidden_dim=16)
    load_pairs(critic_family_pairs(net), params)
    assert [tuple(m.shape) for m in masks] == [(B, 16)] * (3 if dropout else 0)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = net(tx, train=True, dropout=masks)
    _close(got, want)
    got.backward(torch.from_numpy(dy))
    _close(tx.grad, want_dx)


def test_torch_mlp_resnet_block_projects_the_residual():
    """A block whose input width differs from its features adds a projected
    residual (flax's Dense_2)."""
    x, = _inputs(3, (B, F))
    jblock = jmlp.MLPResNetBlock(features=8, use_layer_norm=True)
    params = _perturbed(jblock.init(jax.random.PRNGKey(3), x)["params"], 4)
    assert set(params) == {"Dense_0", "Dense_1", "Dense_2", "LayerNorm_0"}
    block = tmlp.MLPResNetBlock(F, 8, use_layer_norm=True)
    pairs = []
    for name, layer in (("Dense_0", block.up), ("Dense_1", block.down), ("Dense_2", block.proj)):
        pairs += [((name, "kernel"), layer.weight, "T"), ((name, "bias"), layer.bias, None)]
    pairs += [(("LayerNorm_0", "scale"), block.norm.weight, None),
              (("LayerNorm_0", "bias"), block.norm.bias, None)]
    load_pairs(pairs, params)
    _close(block(torch.from_numpy(x)), jblock.apply({"params": params}, x))


def test_torch_policy_dropout_and_init_final_match_flax(monkeypatch):
    x, = _inputs(4, (B, F))
    jnet = jac.PolicyNet(action_dim=A, hidden_dims=(16, 16), activations=fnn.tanh,
                         use_layer_norm=True, dropout_rate=0.25, init_final=0.01)
    init = jnet.init(jax.random.PRNGKey(5), x)["params"]
    net = tac.PolicyNet(F, A, (16, 16), "tanh", use_layer_norm=True, dropout_rate=0.25,
                        init_final=0.01, generator=torch.Generator().manual_seed(0))
    # init_final's range as the JAX module draws it: (-init_final, 0]
    for w in (np.asarray(init["Dense_0"]["kernel"]), net.mean.weight.detach().numpy()):
        assert w.min() >= -0.01 and w.max() <= 0.0
    params = _perturbed(init, 5)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        dist = jnet.apply({"params": params}, x, train=True, rngs={"dropout": jax.random.PRNGKey(6)})
    load_pairs(actor_pairs(net, ()), params)
    got = net(torch.from_numpy(x), train=True, dropout=masks)
    _close(got.loc, dist.loc)
    _close(got.scale, jnp.broadcast_to(dist.scale, dist.loc.shape))
    want = dist.sample_and_log_prob(jax.random.PRNGKey(7))  # the port takes JAX's noise
    noise = jax.random.normal(jax.random.PRNGKey(7), dist.loc.shape)
    a, logp = got.sample_and_log_prob(eps=torch.from_numpy(np.asarray(noise)))
    _close(a, want[0])
    _close(logp, want[1], atol=5e-5)  # a log-density: sums of logs of O(10) terms


def test_torch_critic_action_batches_dropout_and_init_final_match_flax(monkeypatch):
    """(B, A, action) actions give (E, B, A) Q-values, the A axis folded into
    the batch; in train mode with flax's masks."""
    x, acts = _inputs(5, (B, F), (B, 4, A))
    jnet = jac.CriticNet(ensemble_size=2, hidden_dims=(16, 16), activations=fnn.swish,
                         use_layer_norm=True, dropout_rate=0.1, init_final=0.003)
    init = jnet.init(jax.random.PRNGKey(8), x, acts[:, 0])["params"]
    net = tac.CriticNet(F + A, 2, (16, 16), "swish", use_layer_norm=True, dropout_rate=0.1,
                        init_final=0.003)
    for w in (np.asarray(init["EnsembleDense_0"]["kernel"]), net.head.kernel.detach().numpy()):
        assert w.min() >= -0.003 and w.max() <= 0.0
    params = _perturbed(init, 6)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        want = jnet.apply({"params": params}, x, acts, train=True,
                          rngs={"dropout": jax.random.PRNGKey(9)})
    pairs = ensemble_mlp_pairs(net.trunk, ("EnsembleMLP_0",)) + [
        (("EnsembleDense_0", "kernel"), net.head.kernel, None),
        (("EnsembleDense_0", "bias"), net.head.bias, None)]
    load_pairs(pairs, params)
    assert [tuple(m.shape) for m in masks] == [(2, B * 4, 16), (2, B * 4, 16)]
    got = net(torch.from_numpy(x), torch.from_numpy(acts), train=True, dropout=masks)
    assert tuple(got.shape) == (2, B, 4) == np.shape(want)
    _close(got, want)
    # one action per row: (E, B)
    _close(net(torch.from_numpy(x), torch.from_numpy(acts[:, 1])),
           jnet.apply({"params": params}, x, acts[:, 1]))


def test_torch_value_critic_matches_flax():
    x, = _inputs(6, (B, F))
    jnet = jac.ValueCritic(hidden_dims=(16, 16), activations=fnn.tanh, use_layer_norm=True)
    params = _perturbed(jnet.init(jax.random.PRNGKey(10), x)["params"], 7)
    net = tac.ValueCritic(F, (16, 16), "tanh", use_layer_norm=True)
    load_pairs(critic_family_pairs(net), params)
    got = net(torch.from_numpy(x))
    assert tuple(got.shape) == (B,)
    _close(got, jnet.apply({"params": params}, x))


def test_torch_distributional_critic_matches_flax():
    x, acts = _inputs(7, (B, F), (B, A))
    jnet = jac.DistributionalCriticNet(ensemble_size=2, q_low=-1.0, q_high=1.0, num_atoms=11,
                                       hidden_dims=(16, 16))
    params = _perturbed(jnet.init(jax.random.PRNGKey(11), x, acts)["params"], 8)
    want_logits, want_atoms = jnet.apply({"params": params}, x, acts)
    net = tac.DistributionalCriticNet(F + A, 2, -1.0, 1.0, 11, (16, 16))
    load_pairs(critic_family_pairs(net), params)
    logits, atoms = net(torch.from_numpy(x), torch.from_numpy(acts))
    assert tuple(logits.shape) == (2, B, 11) and atoms.shape == logits.shape
    _close(logits, want_logits)
    np.testing.assert_allclose(atoms.numpy(), np.asarray(want_atoms), rtol=0, atol=1e-7)
    q = (torch.softmax(logits.detach(), -1) * atoms).sum(-1)
    assert float(q.min()) >= -1.0 and float(q.max()) <= 1.0


@pytest.mark.parametrize("twin_q", [True, False])
def test_torch_contrastive_critic_matches_flax(twin_q):
    """The halves: obs features then goal features; the outer product of the
    towers' representations, (B, B, 2) with the twin. Swapping the halves
    (the planted fault) moves every logit."""
    x, acts = _inputs(8, (B, 2 * F), (B, A))
    jnet = jac.ContrastiveCritic(sa_hidden_dims=(16, 16), g_hidden_dims=(16, 8), repr_dim=4,
                                 twin_q=twin_q)
    params = _perturbed(jnet.init(jax.random.PRNGKey(12), x, acts)["params"], 9)
    want = jnet.apply({"params": params}, x, acts)
    net = tac.ContrastiveCritic(2 * F, A, (16, 16), (16, 8), 4, twin_q)
    load_pairs(critic_family_pairs(net), params)
    got = net(torch.from_numpy(x), torch.from_numpy(acts))
    assert tuple(got.shape) == ((B, B, 2) if twin_q else (B, B)) == np.shape(want)
    _close(got, want)
    swapped = torch.from_numpy(np.concatenate([x[:, F:], x[:, :F]], -1))
    assert (net(swapped, torch.from_numpy(acts)) - got).abs().min() > 0


def test_torch_tanh_normal_bounds_match_jax():
    """TanhNormal on [low, high]: samples, their log-probs (with the rescale's
    log-det), log_prob of given values, and the mode."""
    loc, scale, eps = _inputs(9, (B, A), (B, A), (B, A))
    scale = np.abs(scale) + 0.1
    low, high = np.asarray([-2.0, 0.0, -0.5], np.float32), np.asarray([1.0, 3.0, 0.5], np.float32)
    jd = JaxTanhNormal(jnp.asarray(loc), jnp.asarray(scale), jnp.asarray(low), jnp.asarray(high))
    td = TanhNormal(*(torch.from_numpy(v) for v in (loc, scale, low, high)))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(13), loc.shape))
    ja, jlp = jd.sample_and_log_prob(jax.random.PRNGKey(13))
    a, lp = td.sample_and_log_prob(eps=torch.from_numpy(noise))
    _close(a, ja)
    _close(lp, jlp, atol=5e-5)
    assert float(a.min()) >= -2.0 and float(a[:, 1].min()) >= 0.0
    _close(td.log_prob(a), jd.log_prob(ja), atol=5e-4)  # atanh near the bounds
    _close(td.mode(), jd.mode())
