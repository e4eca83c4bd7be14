"""The port's SAC learner against serl_tpu's, on the CPU.

Small agents (hidden 32, LayerNorm-tanh MLPs, a 4-member critic ensemble
subsampled to 2, exp std) are built by both packages; the JAX agent's
params (perturbed away from init, the target critic apart from them) and,
where a test says so, its whole mid-training learner state are carried into
the port through `utils/jax_params.py`. Every random draw the port reads is
JAX's own, replayed from the JAX key splits (train_state.py:115-117 over the
sorted group names, sac.py:147, 156, 187, 222 and 273, distributions.py:96).

Tolerances, float32 throughout, sums taken in another order:
  * losses 1e-5 relative; per-group gradients 2e-5 abs + 1e-4 relative;
  * one Adam step from a mid-training state: params, targets and moments
    to 1e-6 abs (a step moves a param by at most ~lr = 1e-3, and the
    update mu_hat / (sqrt(nu_hat) + eps) is smooth in the gradient there);
  * the first Adam step from init with no warmup moves each param by
    lr * g / (|g| + 1e-8), which is ~lr * sign(g): where |g| is at rounding
    level (below 1e-6 of the group's largest |g|), the two sides may step
    in opposite directions, so those elements are held to 2 * lr and every
    other one to 1e-6.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu.training.launcher import make_sac_agent as jax_make_sac_agent
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.training.launcher import make_state_sim_experiment
from serl_tpu_torch.utils.jax_params import (
    group_tree,
    load_sac_params,
    load_train_state,
    train_state_to_jax_layout,
)

OBS, ACT, H, E, S = 6, 3, 32, 4, 2
LR = 1e-3
OPT = {"learning_rate": LR}
FIXTURE = Path(__file__).parent / "fixtures" / "sac_reference_fixture.pkl"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kwargs(tanh):
    net = {"activations": tanh, "use_layer_norm": True, "hidden_dims": (H, H)}
    return dict(policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp",
                               "std_min": 1e-5, "std_max": 5.0},
                critic_network_kwargs=net, policy_network_kwargs=dict(net), temperature_init=1e-2,
                discount=0.99, critic_ensemble_size=E, critic_subsample_size=S,
                actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                temperature_optimizer_kwargs=OPT)


# ---------------------------------------------------------------- JAX side


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), jax.device_get(tree))


def jax_state_np(jagent):
    """The JAX agent's learner state in utils/jax_params.py's layout."""
    st = jagent.state
    opt = {}
    for g, chain in st.opt_states.items():
        adam = next(s for s in chain if isinstance(s, optax.ScaleByAdamState))
        inject = next(s for s in chain if hasattr(s, "hyperparams"))
        counts = {int(adam.count), int(inject.count),
                  int(inject.hyperparams_states["learning_rate"].count)}
        assert len(counts) == 1, counts
        opt[g] = {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": counts.pop(),
                  "learning_rate": float(inject.hyperparams["learning_rate"])}
    return {"params": _np(st.params), "target_params": _np(st.target_params),
            "step": int(st.step), "opt_states": opt}


def jax_with_state(jagent, state_np, rng):
    """`jagent` carrying the learner state `state_np` and the PRNG key `rng`."""
    st = jagent.state
    opt = {}
    for g, chain in st.opt_states.items():
        src = state_np["opt_states"][g]
        count = jnp.asarray(src["count"], jnp.int32)
        parts = []
        for s in chain:
            if isinstance(s, optax.ScaleByAdamState):
                s = s._replace(count=count, mu=jax.tree.map(jnp.asarray, src["mu"]),
                               nu=jax.tree.map(jnp.asarray, src["nu"]))
            elif hasattr(s, "hyperparams"):
                sched = s.hyperparams_states["learning_rate"]._replace(count=count)
                s = s._replace(count=count, hyperparams_states={"learning_rate": sched},
                               hyperparams={"learning_rate": jnp.asarray(src["learning_rate"],
                                                                        jnp.float32)})
            parts.append(s)
        opt[g] = tuple(parts)
    st = st.replace(params=jax.tree.map(jnp.asarray, state_np["params"]),
                    target_params=jax.tree.map(jnp.asarray, state_np["target_params"]),
                    opt_states=opt, step=jnp.asarray(state_np["step"], jnp.int32), rng=rng)
    return jagent.replace(state=st)


def jax_loss_draws(key, group, batch_size, ensemble=E, subsample=S, action_dim=ACT):
    """The draws one loss function takes from the key `update` hands it."""
    shape = (batch_size, action_dim)
    if group == "critic":
        r, k = jax.random.split(key)  # sac.py:147, then 156
        draws = {"critic_next_eps": jax.random.normal(k, shape)}
        if subsample is not None:
            draws["subsample_idx"] = jax.random.randint(jax.random.split(r)[1], (subsample,), 0,
                                                        ensemble)
    elif group == "actor":
        draws = {"actor_eps": jax.random.normal(jax.random.split(key, 4)[2], shape)}  # sac.py:187
    else:
        draws = {"temperature_next_eps": jax.random.normal(jax.random.split(key)[1], shape)}
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if v.dtype == jnp.int32 else np.float32))
            for k, v in draws.items()}


def jax_update_draws(rng, batch_size, networks, **kw):
    """The draws JAX's `update` of `networks` takes from the key `rng`, as
    torch tensors, and the key the update leaves behind."""
    new_rng, *keys = jax.random.split(rng, 4)  # sorted: actor, critic, temperature
    draws = {}
    for group, key in zip(("actor", "critic", "temperature"), keys):
        if group in networks:
            draws.update(jax_loss_draws(key, group, batch_size, **kw))
    return draws, jax.random.split(new_rng)[0]


def jax_high_utd_draws(rng, batch_size, utd_ratio, **kw):
    draws = []
    for _ in range(utd_ratio):
        d, rng = jax_update_draws(rng, batch_size // utd_ratio, {"critic"}, **kw)
        draws.append(d)
    d, rng = jax_update_draws(rng, batch_size, {"actor", "temperature"}, **kw)
    return draws + [d]


# ---------------------------------------------------------------- helpers


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": rng.normal(size=(n, OBS)).astype(np.float32),
            "actions": rng.uniform(-0.95, 0.95, (n, ACT)).astype(np.float32),
            "next_observations": rng.normal(size=(n, OBS)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": (rng.uniform(size=(n,)) > 0.2).astype(np.float32),
            "dones": np.zeros((n,), np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, atol, rtol=0.0, what=""):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), (what, set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol, err_msg=f"{what}{k}")


def assert_states_close(port, jax_np, atol):
    for part in ("params", "target_params"):
        assert_trees_close(port[part], jax_np[part], atol, what=part)
    assert port["step"] == jax_np["step"]
    for g, o in jax_np["opt_states"].items():
        p = port["opt_states"][g]
        assert p["count"] == o["count"] and p["learning_rate"] == pytest.approx(o["learning_rate"])
        assert_trees_close(p["mu"], o["mu"], atol, rtol=1e-5, what=f"{g} mu")
        assert_trees_close(p["nu"], o["nu"], atol * atol, rtol=1e-4, what=f"{g} nu")


@pytest.fixture(scope="module")
def start():
    """A JAX agent (perturbed params, target apart), its learner state after
    three update_high_utd calls, and the port agent."""
    jagent = JaxSACAgent.create_states(jax.random.PRNGKey(0), jnp.zeros((1, OBS)),
                                       jnp.zeros((1, ACT)), **_kwargs(jnp.tanh))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
                          _np(jagent.state.params))
    target = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                          {"critic": params["critic"]})
    jagent = jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target)))
    init = jax_state_np(jagent)
    mid = jagent
    for i in range(3):
        mid, _ = mid.update_high_utd(_jb(_batch(32, 10 + i)), utd_ratio=4)
    tagent = SACAgent.create_states(torch.zeros(1, OBS), torch.zeros(1, ACT),
                                    generator=torch.Generator().manual_seed(1),
                                    **_kwargs("tanh"), device="cpu")
    return jagent, init, jax_state_np(mid), tagent


# ---------------------------------------------------------------- tests


def test_torch_sac_losses_and_group_grads_match_jax(start):
    jagent, init, _, tagent = start
    load_train_state(tagent, init)
    batch = _batch(16, 1)
    params = jagent.state.params
    keys = dict(zip(("actor", "critic", "temperature"), jax.random.split(jax.random.PRNGKey(5), 3)))
    jfns = {"critic": jagent.critic_loss_fn, "actor": jagent.policy_loss_fn,
            "temperature": jagent.temperature_loss_fn}
    tfns = {"critic": tagent.critic_loss_fn, "actor": tagent.policy_loss_fn,
            "temperature": tagent.temperature_loss_fn}
    for g in ("critic", "actor", "temperature"):
        (jloss, jinfo), jgrad = jax.jit(jax.value_and_grad(
            lambda p: jfns[g](_jb(batch), {**params, g: p}, keys[g]), has_aux=True))(params[g])
        draws = jax_loss_draws(keys[g], g, 16)
        loss, info = tfns[g](_tb(batch), draws)
        grads = torch.autograd.grad(loss, tagent.state.params[g], allow_unused=True,
                                    materialize_grads=True)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=g)
        for k, v in jinfo.items():
            np.testing.assert_allclose(float(info[k]), float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{g} {k}")
        assert_trees_close(group_tree(tagent, g, grads), _np(jgrad), atol=2e-5, rtol=1e-4,
                           what=f"{g} grad ")
        for other in ("critic", "actor", "temperature"):
            assert all(p.grad is None for p in tagent.state.params[other])


@pytest.mark.parametrize("networks", ["all", "critic", "actor+temperature"])
def test_torch_update_from_mid_training_matches_jax(start, networks):
    jagent, _, mid, tagent = start
    nets = {"all": {"actor", "critic", "temperature"}, "critic": {"critic"},
            "actor+temperature": {"actor", "temperature"}}[networks]
    key = jax.random.PRNGKey(7)
    load_train_state(tagent, mid)
    batch = _batch(16, 2)
    jnew, jinfo = jax_with_state(jagent, mid, key).update(_jb(batch), networks_to_update=frozenset(nets))
    draws, _ = jax_update_draws(key, 16, nets)
    _, info = tagent.update(_tb(batch), networks_to_update=frozenset(nets), draws=draws)
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jnew), atol=1e-6)
    assert set(info) == set(jinfo)
    for g in ("actor", "critic", "temperature"):
        assert set(info[g]) == set(jinfo[g])
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=1e-5, atol=1e-7)
        assert info[f"{g}_lr"] == pytest.approx(float(jinfo[f"{g}_lr"]))


def test_torch_first_update_from_init_matches_jax(start):
    """Adam's first step with no warmup is ~lr * sign(g): see the module
    docstring for how elements with |g| at rounding level are held."""
    jagent, init, _, tagent = start
    key = jax.random.PRNGKey(8)
    load_train_state(tagent, init)
    batch = _batch(16, 3)
    jnew, _ = jax_with_state(jagent, init, key).update(_jb(batch))
    draws, _ = jax_update_draws(key, 16, {"actor", "critic", "temperature"})
    tagent.update(_tb(batch), draws=draws)
    got, want = train_state_to_jax_layout(tagent), jax_state_np(jnew)
    moved = jax.tree.map(lambda a, b: np.abs(a - b).max(), want["params"], init["params"])
    assert max(jax.tree.leaves(moved)) > 0.5 * LR  # the step really moved the params
    g_jax = want["opt_states"]  # after one step mu = (1 - b1) * g
    for group in ("actor", "critic", "temperature"):
        gw, gm = _leaves(want["params"][group]), _leaves(got["params"][group])
        mu = _leaves(g_jax[group]["mu"])
        scale = max(np.abs(v).max() for v in mu.values())
        for k in gw:
            tiny = np.abs(mu[k]) < 1e-6 * scale
            err = np.abs(gm[k] - gw[k])
            assert err[~tiny].max(initial=0) <= 1e-6, (group, k, err[~tiny].max())
            assert err[tiny].max(initial=0) <= 2 * LR + 1e-7, (group, k)


def test_torch_update_high_utd_matches_jax(start):
    jagent, _, mid, tagent = start
    key = jax.random.PRNGKey(9)
    load_train_state(tagent, mid)
    batch = _batch(32, 4)
    jnew, jinfo = jax_with_state(jagent, mid, key).update_high_utd(_jb(batch), utd_ratio=4)
    _, info = tagent.update_high_utd(_tb(batch), utd_ratio=4,
                                     draws=jax_high_utd_draws(key, 32, 4))
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jnew), atol=2e-6)
    assert set(info) == set(jinfo) == {"critic", "actor", "temperature", "actor_lr",
                                       "critic_lr", "temperature_lr"}
    for g in ("critic", "actor", "temperature"):
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        tagent.update_high_utd(_tb(_batch(30, 0)), utd_ratio=4)


def test_torch_twenty_update_high_utd_calls_track_jax(start):
    """20 update_high_utd calls in a row (100 optimizer steps, 100 target
    updates) from the mid-training state, each with JAX's draws: every
    call's losses within 1e-4 relative and, at the end, params, targets and
    Adam moments within 1e-4 of JAX's. Drift that builds up over steps (the
    optimizer's count, the polyak targets, the temperature) shows here and
    not in one call."""
    jagent, _, mid, tagent = start
    jagent = jax_with_state(jagent, mid, jax.random.PRNGKey(21))
    load_train_state(tagent, mid)
    for i in range(20):
        batch = _batch(32, 200 + i)
        draws = jax_high_utd_draws(jagent.state.rng, 32, 4)
        jagent, jinfo = jagent.update_high_utd(_jb(batch), utd_ratio=4)
        _, info = tagent.update_high_utd(_tb(batch), utd_ratio=4, draws=draws)
        for g, k in (("critic", "critic_loss"), ("actor", "actor_loss"),
                     ("actor", "temperature"), ("actor", "entropy")):
            np.testing.assert_allclose(float(info[g][k]), float(jinfo[g][k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"call {i} {k}")
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jagent), atol=1e-4)


def test_torch_update_draws_from_generator_run():
    agent = SACAgent.create_states(torch.zeros(1, OBS), torch.zeros(1, ACT),
                                   generator=torch.Generator().manual_seed(0), **_kwargs("tanh"),
                                   device="cpu")
    before = [p.clone() for p in agent.parameters()]
    _, info = agent.update_high_utd(_tb(_batch(32, 5)), utd_ratio=4,
                                    generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v) for v in info["critic"].values())
    assert any((a != b).any() for a, b in zip(agent.parameters(), before))
    assert agent.state.step == 5 and agent.state.opt_states["critic"].count == 5


def test_torch_losses_match_reference_fixture():
    """The upstream SERL numbers of tests/fixtures/sac_reference_fixture.pkl
    (see tests/test_reference_fixtures.py for the graft), through the port's
    critic loss fed next actions equal to the fixture's, and its Lagrange
    penalty."""
    with open(FIXTURE, "rb") as f:
        fx = pickle.load(f)
    ref = fx["params"]
    crit = ref["modules_critic"]
    actor = dict(ref["modules_actor"])
    first = lambda ln: jax.tree.map(lambda x: np.asarray(x)[0], ln)  # members equal at init
    params = {
        "actor": {"MLP_0": actor["network"], "Dense_0": actor["Dense_0"], "Dense_1": actor["Dense_1"]},
        "critic": {"encoder": {}, "head": {
            "EnsembleMLP_0": {"EnsembleDense_0": crit["network"]["Dense_0"],
                              "EnsembleDense_1": crit["network"]["Dense_1"],
                              "LayerNorm_0": first(crit["network"]["LayerNorm_0"]),
                              "LayerNorm_1": first(crit["network"]["LayerNorm_1"])},
            "EnsembleDense_0": crit["Dense_0"]}},
        "temperature": {"raw": ref["modules_temperature"]["lagrange"]},
    }
    from serl_tpu_torch.training.launcher import make_sac_agent

    agent = make_sac_agent(0, obs_dim=13, action_dim=7, device="cpu")
    load_sac_params(agent, jax.tree.map(np.asarray, params))
    agent.init_train_state(OPT, OPT, OPT)  # the target critic is a copy of the grafted one
    agent.config = agent.config._replace(critic_subsample_size=None)  # min over all 10
    b = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in fx["batch"].items()}
    with torch.no_grad():
        dist = agent.forward_policy(b["next_observations"])
        eps = (torch.atanh(b["given_next_actions"].double()) - dist.loc.double()) / dist.scale.double()
    loss, info = agent.critic_loss_fn(b, {"critic_next_eps": eps.float()})
    np.testing.assert_allclose(float(info["target_qs"]), fx["target_q"].mean(), rtol=1e-4)
    np.testing.assert_allclose(loss.item(), fx["critic_mse"], rtol=1e-4)
    np.testing.assert_allclose(agent.temperature().item(), fx["temperature"], rtol=1e-6)
    from serl_tpu_torch.networks.lagrange import lagrange_penalty

    pen = lagrange_penalty({"raw": agent.temperature_raw}, lhs=torch.tensor(fx["entropy_lhs"]),
                           rhs=fx["config"]["target_entropy"])
    np.testing.assert_allclose(pen.item(), fx["lagrange_penalty"], rtol=1e-5)


def test_torch_learner_slice_matches_jax_update_high_utd(monkeypatch):
    """The port's loop on the CPU past its training threshold (8 envs, batch
    16, UTD 2): the batch its sampler drew and the state before its second
    learner call go through JAX's update_high_utd, with the same draws; the
    new learner states agree."""
    env, agent, rb, config, init_fn, run_chunk = make_state_sim_experiment(
        seed=0, device="cpu", num_envs=8, batch_size=16, utd_ratio=2, training_starts=32,
        random_steps=24, buffer_capacity=400)
    agent.init_train_state(OPT, OPT, OPT)
    records, keys = [], iter(jax.random.split(jax.random.PRNGKey(11), 8))
    inner = agent.update_high_utd

    def spy(batch, *, utd_ratio, draws=None, generator=None):
        assert draws is None and isinstance(generator, torch.Generator)
        key = next(keys)
        rec = {"key": key, "before": train_state_to_jax_layout(agent),
               "batch": {k: v.numpy().copy() for k, v in batch.items()}}
        out = inner(batch, utd_ratio=utd_ratio,
                    draws=jax_high_utd_draws(key, batch["rewards"].shape[0], utd_ratio,
                                             ensemble=10, action_dim=4))
        rec["after"], rec["info"] = train_state_to_jax_layout(agent), out[1]
        records.append(rec)
        return out

    monkeypatch.setattr(agent, "update_high_utd", spy)
    carry, metrics = run_chunk(init_fn(agent, 0), 5)
    assert len(records) == 2  # the insert of iteration 4 reaches 32 rows
    np.testing.assert_array_equal(metrics["critic_loss"][:3].numpy(), 0)
    assert (metrics["critic_loss"][3:] > 0).all() and torch.isfinite(metrics["actor_loss"]).all()
    rec = records[-1]
    assert rec["batch"]["observations"].shape == (32, 10)
    jagent = jax_make_sac_agent(0, actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                                temperature_optimizer_kwargs=OPT)
    jnew, jinfo = jax_with_state(jagent, rec["before"], rec["key"]).update_high_utd(
        _jb(rec["batch"]), utd_ratio=2)
    assert_states_close(rec["after"], jax_state_np(jnew), atol=2e-6)
    np.testing.assert_allclose(float(rec["info"]["critic"]["critic_loss"]),
                               float(jinfo["critic"]["critic_loss"]), rtol=1e-5)


def test_torch_sac_learns_simple_problem():
    """A 1-step bandit, reward = -|a - 0.5| (tests/test_sac.py's), learned by
    the port's SAC from numpy-seeded batches."""
    obs_dim, act_dim = 3, 2
    agent = SACAgent.create_states(
        torch.zeros(1, obs_dim), torch.zeros(1, act_dim), generator=torch.Generator().manual_seed(0),
        policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp"},
        critic_network_kwargs={"hidden_dims": (64, 64)}, policy_network_kwargs={"hidden_dims": (64, 64)},
        temperature_init=1e-2, discount=0.0, critic_ensemble_size=2,
        actor_optimizer_kwargs={"learning_rate": 3e-3}, critic_optimizer_kwargs={"learning_rate": 3e-3},
        device="cpu")
    rng = np.random.default_rng(1)
    g = torch.Generator().manual_seed(2)
    for _ in range(500):
        obs = torch.from_numpy(rng.normal(size=(128, obs_dim)).astype(np.float32))
        acts = torch.from_numpy(rng.uniform(-1, 1, (128, act_dim)).astype(np.float32))
        batch = {"observations": obs, "actions": acts, "next_observations": obs,
                 "rewards": -(acts - 0.5).abs().sum(-1), "masks": torch.zeros(128),
                 "dones": torch.ones(128)}
        agent.update(batch, generator=g)
    test_obs = torch.from_numpy(np.random.default_rng(9).normal(size=(16, obs_dim)).astype(np.float32))
    err = (agent.sample_actions(test_obs, argmax=True) - 0.5).abs().mean().item()
    assert err < 0.2, f"SAC failed to learn the bandit, err={err}"
