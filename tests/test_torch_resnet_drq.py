"""The DrQ agent with the ResNet encoders against serl_tpu's, on the CPU.

- `update_high_utd` with "resnet-pretrained" (the committed ResNet-10
  grafted into both cameras' frozen backbones; 32 px; critic and policy
  width 32, a 4-member critic subsampled to 2): the JAX agent's params
  (the heads perturbed, the backbones as grafted), its target critic apart
  from them and a mid-run optimizer state are carried into the port, and
  one update_high_utd runs in both on the same batch with every draw
  JAX's own: DrQ's crop offsets, SAC's noise and subsample indices
  (tests/test_torch_drq.py, tests/test_torch_learner.py), and the dropout
  keep-mask of every encoder pass, recorded from flax as JAX runs (eagerly,
  under jax.disable_jit) and fed to the port in the losses' pass order.
  Held as tests/test_torch_learner.py holds the learner state: 2e-6 abs on
  params and targets after the minibatch and the full-batch Adam steps
  (measured: 1.2e-7), the infos to 1e-5 relative.
  The optimizer state is a mid-run one (Adam moments of the scale a
  training run has, count 10): from zero moments Adam's first step maps a
  gradient g to g / (|g| + 1e-8), so noise-level gradients of the 4,096-wide
  bottleneck would move by up to a learning rate on either side.
- The frozen backbones come out of updates bit for bit as grafted (Adam on
  zero gradients, no weight decay), the heads move, the target backbones
  move only by the polyak average of equal values.
- Acting runs without dropout; the losses' passes run with it.
- The "resnet" and "resnet-pretrained" encoders' parameter trees carry
  flax's names and shapes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.agents.drq import make_image_encoders as jax_image_encoders
from serl_tpu.vision.encoding import ObsEncoder as JaxObsEncoder
from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.utils import pretrained
from serl_tpu_torch.utils.jax_params import (
    _encoder_pairs,
    load_train_state,
    to_jax_layout,
    train_state_to_jax_layout,
)
from tests.test_torch_drq import _batch, _jb, _tb, _tree, jax_augment_draws
from tests.test_torch_learner import (
    assert_states_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.test_torch_resnet import recording_dropout

PKL = Path(__file__).resolve().parent.parent / "resnet10_params.pkl"
KEYS = ("front", "wrist")
H, E, S, ACT = 32, 4, 2, 4
OPT = {"learning_rate": 1e-3}
# the losses' encoder passes in flax's call order, per update: a critic
# update's next actions, target critic and critic; the actor+temperature
# update's policy and critic (actor loss) and next actions (temperature loss)
CRITIC_PASSES = ("critic_next", "target", "critic")
ACTOR_PASSES = ("actor", "actor_critic", "temperature_next")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(PKL))


def _kwargs():
    net = {"activations": "tanh", "use_layer_norm": True, "hidden_dims": (H, H)}
    return dict(image_keys=KEYS, encoder_type="resnet-pretrained",
                policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp",
                               "std_min": 1e-5, "std_max": 5.0},
                critic_network_kwargs=net, policy_network_kwargs=dict(net), temperature_init=1e-2,
                discount=0.96, critic_ensemble_size=E, critic_subsample_size=S,
                actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                temperature_optimizer_kwargs=OPT)


def _frozen(path) -> bool:
    return "pretrained_encoder" in [getattr(p, "key", None) for p in path]


def _example():
    return _tree(lambda x: x[:1], _batch(1, 0)["observations"])


def _port_agent():
    return DrQAgent.create_drq(_tb(_example()), torch.zeros(1, ACT),
                               generator=torch.Generator().manual_seed(1), device="cpu",
                               **_kwargs())


def _backbones(agent):
    return [p for k in KEYS
            for p in agent.encoder.encoders[k].pretrained_encoder.parameters()]


def test_torch_resnet_pretrained_update_high_utd_matches_jax(monkeypatch):
    jagent = JaxDrQAgent.create_drq(jax.random.PRNGKey(0), _jb(_example()), jnp.zeros((1, ACT)),
                                    **_kwargs())
    rng = np.random.default_rng(0)

    def perturb(tree, scale):  # the heads, not the grafted backbones
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.asarray(x) if _frozen(p)
            else (np.asarray(x) + scale * rng.normal(size=x.shape)).astype(np.float32), tree)

    def moments(tree, scale, square):  # a frozen leaf never had a gradient
        return jax.tree_util.tree_map_with_path(
            lambda p, x: np.zeros_like(x) if _frozen(p)
            else ((scale * rng.normal(size=x.shape)) ** (1 + square) + 1e-6 * square)
            .astype(np.float32), tree)

    params = perturb(jax.device_get(jagent.state.params), 0.1)
    start = jax_state_np(jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params),
        target_params=jax.tree.map(jnp.asarray, perturb({"critic": params["critic"]}, 0.05)))))
    for o in start["opt_states"].values():
        o["mu"], o["nu"], o["count"] = moments(o["mu"], 1e-3, 0), moments(o["nu"], 1e-2, 1), 10
    start["step"] = 10

    key, batch = jax.random.PRNGKey(9), _batch(4, 4)
    masks = recording_dropout(monkeypatch)
    with jax.disable_jit():
        jnew, jinfo = jax_with_state(jagent, start, key).update_high_utd(_jb(batch), utd_ratio=1)
    assert len(masks) == 2 * (len(CRITIC_PASSES) + len(ACTOR_PASSES))
    assert all(m.shape == (4, 512 * 8) for m in masks) and 0.85 < float(
        torch.stack(masks).float().mean()) < 0.95

    offsets, rng_key = jax_augment_draws(key, 4)
    updates = jax_high_utd_draws(rng_key, 4, 1, ensemble=E, subsample=S, action_dim=ACT)
    recorded = iter(masks)
    for draws, passes in zip(updates, (CRITIC_PASSES, ACTOR_PASSES)):
        for name in passes:
            draws[f"{name}_dropout"] = {k: next(recorded) for k in KEYS}
    agent = _port_agent()
    load_train_state(agent, start)
    _, info = agent.update_high_utd(_tb(batch), utd_ratio=1,
                                    draws={"augment": offsets, "updates": updates})
    got, want = train_state_to_jax_layout(agent), jax_state_np(jnew)
    assert_states_close(got, want, atol=2e-6)
    for g in ("critic", "actor", "temperature"):
        for k, v in jinfo[g].items():
            np.testing.assert_allclose(float(info[g][k]), float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{g} {k}")
    # the backbones did not move in either package
    for k in KEYS:
        jax.tree.map(np.testing.assert_array_equal,
                     got["params"]["critic"]["encoder"][f"encoders_{k}"]["pretrained_encoder"],
                     start["params"]["critic"]["encoder"][f"encoders_{k}"]["pretrained_encoder"])


def test_torch_frozen_backbone_stays_as_grafted():
    agent = _port_agent()
    grafted = [p.detach().clone() for p in _backbones(agent)]
    heads = [p.detach().clone() for k in KEYS for p in agent.encoder.encoders[k].pool.parameters()]
    agent.init_train_state(OPT, OPT, OPT)  # lr 1e-3 from the first step
    g = torch.Generator().manual_seed(2)
    for seed in range(3):
        agent.update_high_utd(_tb(_batch(4, 20 + seed)), utd_ratio=2, generator=g)
    assert all(torch.equal(p, q) for p, q in zip(_backbones(agent), grafted))
    moved = [not torch.equal(p, q) for p, q in
             zip([p for k in KEYS for p in agent.encoder.encoders[k].pool.parameters()], heads)]
    assert all(moved)
    # no gradient reaches a backbone, and its Adam moments stay zero
    critic = agent.state.params["critic"]
    idx = [next(i for i, q in enumerate(critic) if q is p) for p in _backbones(agent)]
    opt = agent.state.opt_states["critic"]
    assert all(not bool(opt.mu[i].any()) and not bool(opt.nu[i].any()) for i in idx)
    # the target's backbone: the polyak average of equal values, within two
    # ulps per target update (6: one per critic update), element by element
    for i in idx:
        t, p = agent.state.target_params["critic"][i], critic[i].detach()
        assert bool(((t - p).abs() <= 6 * 2.0 ** -22 * p.abs()).all())


def test_torch_acting_has_no_dropout_and_the_losses_have():
    agent = _port_agent()
    obs = _tb(_batch(3, 5)["observations"])
    a1 = agent.sample_actions(obs, argmax=True)
    a2 = agent.sample_actions(obs, argmax=True)
    assert torch.equal(a1, a2)
    draws = agent.update_draws(3, generator=torch.Generator().manual_seed(0))
    names = {f"{p}_dropout" for p in CRITIC_PASSES + ACTOR_PASSES}
    assert names <= set(draws)
    assert all(set(draws[n]) == set(KEYS) and draws[n]["front"].shape == (3, 512 * 8)
               for n in names)
    with torch.no_grad():
        plain = agent._encode(obs)
        trained = agent._encode(obs, train=True, dropout=draws["critic_dropout"])
        with pytest.raises(ValueError, match="keep-mask"):  # a draw the caller left out
            agent._encode(obs, train=True)
    assert torch.equal(plain, agent._encode(obs).detach()) and not torch.equal(plain, trained)


@pytest.mark.parametrize("encoder_type", ["resnet", "resnet-pretrained"])
def test_torch_resnet_encoder_trees_match_flax_names(encoder_type):
    """The ObsEncoder's parameters under flax's names and shapes (from
    flax's init, traced for shapes only)."""
    jencs = jax_image_encoders(encoder_type, KEYS)
    jobs = JaxObsEncoder(encoders=jencs, image_keys=KEYS, shared_batch_concat=True)
    example = _jb(_example())
    shapes = jax.eval_shape(jobs.init, jax.random.PRNGKey(0), example)["params"]
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    if encoder_type == "resnet-pretrained":
        agent = _port_agent()
    else:
        kw = {**_kwargs(), "encoder_type": encoder_type}
        agent = DrQAgent.create_drq(_tb(_example()), torch.zeros(1, ACT), device="cpu",
                                    generator=torch.Generator().manual_seed(0), **kw)
    flax_shape = {"HWIO": lambda t: t.permute(2, 3, 1, 0).shape, "T": lambda t: t.T.shape,
                  None: lambda t: t.shape}
    got = {"".join(f"['{p}']" for p in path): tuple(flax_shape[layout](t))
           for path, t, layout in _encoder_pairs(agent.encoder, root=())}
    assert got == want
    tree = to_jax_layout(agent)["critic"]["encoder"]
    assert set(tree) == {"encoders_front", "encoders_wrist", "Dense_0", "LayerNorm_0"}
    if encoder_type == "resnet":
        first = agent.encoder.encoders["front"].blocks[0].convs[0]
        assert agent.encoder.encoders["front"].compute_dtype == torch.bfloat16
        # kaiming_normal: variance 2 / fan_in
        assert abs(float(first.weight.std()) * np.sqrt(64 * 9 / 2) - 1.0) < 0.1
    else:
        assert pretrained.find_params_file() == str(PKL)
