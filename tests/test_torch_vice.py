"""The port's VICE agent against serl_tpu's, on the CPU.

Small VICE agents (two cameras at 32 px through narrow float32
SmallEncoders, the DrQ encoders given as `custom_encoders` and the VICE
classifier's on the front camera patched into both packages' registry
calls; LayerNorm-tanh MLPs of width 32; a 4-member critic subsampled to 2;
lr 1e-3 in every group) are built by both packages. JAX's params, perturbed,
and its learner state after an update_high_utd and an update_vice (so every
group's Adam moments are mid-run: a first step from zero moments maps g to
g / |g|, which is ill-conditioned) are carried into the port through
`utils/jax_params.py`, the "vice" group included. Then three calls mixing
the two updates (update_vice, update_high_utd with the VICE reward,
update_vice) run in both, every draw the port reads JAX's own (replayed
from the key splits of `serl_tpu/agents/vice.py`: the crop offsets, lam,
the permutation, the penalty's eps; the head's two dropout masks recorded
as flax draws them), and after each call the whole learner state agrees:
every group's params, the target critic, Adam's moments and counts (each
call steps every group, the others with zero gradients).

Tolerances, float32: bce_loss and grad_norm 1e-5 relative; states as
tests/test_torch_learner.py's assert_states_close at 5e-6 abs (the penalty's
double backward adds a few roundings to the head's gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents import vice as jvice
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu_torch.agents import vice
from serl_tpu_torch.examples import vice_online
from serl_tpu_torch.utils.jax_params import load_train_state, to_jax_layout, train_state_to_jax_layout
from serl_tpu_torch.vision.encoders import SmallEncoder
from tests.test_torch_drq import (
    ACT,
    BOTTLENECK,
    E,
    FEATURES,
    KEYS,
    S,
    SIZE,
    _batch,
    _jb,
    _kwargs,
    _np,
    _tb,
    _tree,
    jax_augment_draws,
)
from tests.test_torch_learner import assert_states_close, jax_loss_draws, jax_state_np, jax_with_state
from tests.test_torch_resnet import recording_dropout

VICE_KEYS = ("front",)
OPT = {"learning_rate": 1e-3}
GROUPS = ("actor", "critic", "temperature", "vice")  # sorted: JAX splits its keys in this order


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _narrow_registry(monkeypatch):
    """Both packages' VICE encoders: narrow float32 SmallEncoders."""
    monkeypatch.setattr(jvice, "make_image_encoders", lambda et, keys, shared=False: {
        k: JaxSmallEncoder(features=FEATURES, bottleneck_dim=BOTTLENECK,
                           compute_dtype=jnp.float32, name=f"encoder_{k}") for k in keys})
    monkeypatch.setattr(vice, "make_image_encoders", lambda et, keys, generator=None, **kw: {
        k: SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK, generator=generator)
        for k in keys})


def _agents(monkeypatch):
    _narrow_registry(monkeypatch)
    example = _tree(lambda x: x[:1], _batch(1, 0)["observations"])
    kw = {**_kwargs(jnp.tanh), "vice_optimizer_kwargs": OPT}
    jencs = {k: JaxSmallEncoder(features=FEATURES, bottleneck_dim=BOTTLENECK,
                                compute_dtype=jnp.float32, name=f"encoder_{k}") for k in KEYS}
    jagent = jvice.VICEAgent.create_vice(jax.random.PRNGKey(0), _jb(example), jnp.zeros((1, ACT)),
                                         vice_image_keys=VICE_KEYS, custom_encoders=jencs, **kw)
    tencs = {k: SmallEncoder(3, FEATURES, bottleneck_dim=BOTTLENECK) for k in KEYS}
    tagent = vice.VICEAgent.create_vice(
        _tb(example), torch.zeros(1, ACT), vice_image_keys=VICE_KEYS, custom_encoders=tencs,
        generator=torch.Generator().manual_seed(1), device="cpu",
        **{**_kwargs("tanh"), "vice_optimizer_kwargs": OPT})
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
                          _np(jagent.state.params))
    target = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                          {"critic": params["critic"]})
    jagent = jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target)))
    mid, _ = jagent.update_high_utd(_jb(_batch(8, 30)), utd_ratio=2)
    mid, _ = mid.update_vice(_jb(_batch(8, 31)))
    return jagent, jax_state_np(mid), tagent


def vice_update_draws(rng, batch_size, networks):
    """The draws of one SAC `update` of a VICE agent (its train state splits
    one key per group, four groups), and the key it leaves behind."""
    new_rng, *keys = jax.random.split(rng, len(GROUPS) + 1)
    draws = {}
    for group, key in zip(GROUPS, keys):
        if group in networks:
            draws.update(jax_loss_draws(key, group, batch_size, ensemble=E, subsample=S,
                                        action_dim=ACT))
    return draws, jax.random.split(new_rng)[0]


def vice_high_utd_draws(key, batch_size, utd_ratio):
    offsets, rng = jax_augment_draws(key, batch_size)
    updates = []
    for _ in range(utd_ratio):
        d, rng = vice_update_draws(rng, batch_size // utd_ratio, {"critic"})
        updates.append(d)
    d, rng = vice_update_draws(rng, batch_size, {"actor", "temperature"})
    return {"augment": offsets, "updates": updates + [d]}


def update_vice_draws(key, b, masks):
    """update_vice's draws from the agent's key (vice.py:100-148): the crop
    offsets per image key, lam, the permutation, eps; the two head masks
    flax drew (the mixed pass, then the penalty's)."""
    rng, aug_key = jax.random.split(key)
    offsets = {}
    for k in KEYS:
        aug_key, kk = jax.random.split(aug_key)
        offsets[k] = torch.from_numpy(np.array(jax.random.randint(kk, (b, 2), 0, 9))).long()
    _, rng = jax.random.split(rng)  # key_enc
    n = 2 * b
    k0, k1, rng = jax.random.split(rng, 3)
    lam = jax.random.beta(k0, 1.0, 1.0)
    perm = jax.random.permutation(k1, n)
    k2, rng = jax.random.split(rng)
    eps = jax.random.uniform(k2, (n // 2, 1))
    t = lambda x: torch.from_numpy(np.array(x))
    assert [tuple(m.shape) for m in masks] == [(n, 256), (n // 2, 256)]
    return {"augment": offsets, "encoder_dropout": {}, "lam": t(lam), "perm": t(perm).long(),
            "eps": t(eps), "dropout": masks[0], "gp_dropout": masks[1]}


def test_torch_create_vice_tree_matches_jax():
    """create_vice at the registry's full width: the port's params carry
    flax's names and shapes in every group, the "vice" group's optimizer is
    make_optimizer(3e-4), and JAX's learner state loads into the port."""
    example = {"state": np.zeros((1, 7), np.float32),
               **{k: np.zeros((1, 1, SIZE, SIZE, 3), np.uint8) for k in KEYS}}
    jagent = jvice.VICEAgent.create_vice(jax.random.PRNGKey(0), _jb(example), jnp.zeros((1, ACT)),
                                         encoder_type="small", image_keys=KEYS,
                                         vice_image_keys=VICE_KEYS, discount=0.97)
    tagent = vice.VICEAgent.create_vice(_tb(example), torch.zeros(1, ACT), encoder_type="small",
                                        image_keys=KEYS, vice_image_keys=VICE_KEYS, discount=0.97,
                                        generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(np.shape, tree)
    assert shapes(to_jax_layout(tagent)) == shapes(_np(jagent.state.params))
    assert sorted(tagent.state.txs) == sorted(jagent.state.txs) == list(GROUPS)
    assert tagent.state.txs["vice"].learning_rate == 3e-4
    assert tagent.state.txs["vice"].warmup_steps == 0
    assert tagent.config.vice_image_keys == VICE_KEYS and tagent.config.discount == 0.97
    state = jax_state_np(jagent)
    load_train_state(tagent, state)
    assert_states_close(train_state_to_jax_layout(tagent), state, atol=0)
    # VICE's critic-only update replaces DrQ's rewards by its classifier's
    # (tests/test_torch_agents_rest.py holds it to JAX's)
    assert "update_critics" in vars(vice.VICEAgent)


def test_torch_vice_updates_match_jax_in_a_mixed_sequence(monkeypatch):
    """update_vice, update_high_utd (rewards from the classifier), update_vice."""
    jagent, mid, tagent = _agents(monkeypatch)
    load_train_state(tagent, mid)
    jcur = jax_with_state(jagent, mid, jax.random.PRNGKey(11))
    masks = recording_dropout(monkeypatch)
    for i, kind in enumerate(("vice", "sac", "vice")):
        key = jcur.state.rng
        if kind == "vice":
            batch = _batch(8, 40 + i)
            masks.clear()
            with jax.disable_jit():
                jcur, jinfo = jcur.update_vice(_jb(batch))
            draws = update_vice_draws(key, 8, list(masks))
            _, info = tagent.update_vice(_tb(batch), draws=draws)
            assert set(info) == set(GROUPS)
            for k in ("bce_loss", "grad_norm"):
                np.testing.assert_allclose(float(info["vice"][k]), float(jinfo["vice"][k]),
                                           rtol=1e-5, err_msg=f"call {i} {k}")
            assert np.isfinite(float(info["vice"]["bce_loss"]))
        else:
            batch = _batch(8, 50 + i)
            jcur, jinfo = jcur.update_high_utd(_jb(batch), utd_ratio=2)
            _, info = tagent.update_high_utd(_tb(batch), utd_ratio=2,
                                             draws=vice_high_utd_draws(key, 8, 2))
            np.testing.assert_allclose(float(info["vice_rewards"]), float(jinfo["vice_rewards"]))
            np.testing.assert_allclose(float(info["critic"]["critic_loss"]),
                                       float(jinfo["critic"]["critic_loss"]), rtol=1e-5)
        want = jax_state_np(jcur)
        assert_states_close(train_state_to_jax_layout(tagent), want, atol=5e-6)
        counts = {g: o.count for g, o in tagent.state.opt_states.items()}
        assert len(set(counts.values())) == 1, counts  # every group stepped every time


def test_torch_update_vice_moves_only_the_head(monkeypatch):
    """From zero vice moments, an update_vice moves the vice head; the VICE
    encoders (no gradient reaches them) and every other group stay, Adam's
    zero-gradient steps on zero moments moving nothing."""
    _, _, tagent = _agents(monkeypatch)
    before = {g: [p.detach().clone() for p in ps] for g, ps in tagent.state.params.items()}
    _, info = tagent.update_vice(_tb(_batch(8, 60)), generator=torch.Generator().manual_seed(0))
    moved = {g: [not torch.equal(p, q) for p, q in zip(tagent.state.params[g], before[g])]
             for g in before}
    head = {id(p) for p in tagent.vice.head.parameters()}
    for p, m in zip(tagent.state.params["vice"], moved["vice"]):
        assert m == (id(p) in head)
    assert not any(any(m) for g, m in moved.items() if g != "vice")
    assert np.isfinite(float(info["vice"]["grad_norm"]))


def test_torch_vice_online_flags_and_batch():
    args = vice_online.parser().parse_args([])
    assert (args.num_envs, args.batch_size, args.utd_ratio, args.image_size,
            args.vice_updates_per_chunk, args.vice_batch, args.intervention_prob,
            args.intervention_decay_steps, args.total_steps, args.eval_period) == (
        16, 256, 4, 128, 4, 128, 0.3, 40_000, 120_000, 4000)
    assert vice_online.VICE_KEYS == ("front",) and vice_online.CHUNK == 10
