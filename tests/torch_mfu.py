"""The JAX package's measurement tools beside the port's, for the tools' CPU
tests (test_torch_mfu*_tool.py, test_torch_sol_tool.py).

`load_jax_tool(name)` loads `tools/<name>.py` by path (its import points
JAX's compilation cache at another directory: the test run's is put back).

`variant_parity(jtool, variant, ...)` holds one lever of `mfu_experiments`
against the JAX tool's. Both tools' `make_agent` build the agent; the JAX
agent's params are grafted into the port's (`load_sac_params`; the target
critic is a copy of the critic in both, as at creation). Then:
  * the encoder features (both cameras and the proprio Dense) at the
    variant's own compute dtype: in bfloat16 under tests/test_torch_encoder.py's
    rule, 0.05 abs and 0.005 mean abs (the two frameworks round the
    convolutions at different places); in float32 within 1e-5 abs and 1e-6
    mean abs, that file's 2e-6 for sums of up to 144 terms grown with the
    square root of the full width's 1,152 (2.6e-6 and 2.9e-7 measured at
    32 px);
  * one update_high_utd, fed JAX's crop offsets and SAC draws (the key
    splits of tests/test_torch_drq.py), with every dropout keep-mask a fixed
    pattern of its shape in both (flax's bernoulli swapped for it; the
    learned-embedding head drops 10% of its features in train mode): the
    critic, actor and temperature losses within tests/test_torch_drq.py's
    1e-5 relative, 1e-7 absolute, and every other info of those groups
    within 1e-5 relative or 1e-5 absolute (the entropy is a mean of
    log-probs of order 1 that cancel to ~0.03 here: 2e-6 apart measured
    with the shared encoder applied per camera). The losses are
    taken with the convolutions in float32 in both packages, as
    tests/test_torch_drq.py's agents have them (each package's SmallEncoder
    is swapped for one whose compute dtype is float32): in bfloat16 XLA and
    oneDNN round at different places, 0.4% a value.
"""

import importlib.util
from pathlib import Path

import flax.linen.stochastic as stochastic
import jax
import jax.numpy as jnp
import numpy as np
import torch

import serl_tpu.vision.encoders as jax_encoders
import serl_tpu_torch.vision.encoders as torch_encoders
from serl_tpu_torch.agents.sac import encoder_dropout_shapes
from serl_tpu_torch.tools import mfu_experiments as tool
from serl_tpu_torch.utils.jax_params import load_sac_params
from tests.test_torch_drq import jax_augment_draws
from tests.test_torch_learner import jax_high_utd_draws

ROOT = Path(__file__).resolve().parents[1]
ENSEMBLE, SUBSAMPLE = 10, 2
FEATURE_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (0.05, 0.005)}  # max, mean abs
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-7
INFO_ATOL = 1e-5  # the infos that are not losses
PASSES = {"critic": ("critic_next", "target", "critic"), "actor": ("actor", "actor_critic"),
          "temperature": ("temperature_next",)}


def load_jax_tool(name: str):
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return module


def parity_batch(batch: int, utd: int, size: int) -> dict:
    """numpy arrays: the port tool's batch (seed 0) with the next
    observations of seed 1's, uniform rewards and some masks at 0."""
    t = lambda tree: {k: (t(v) if isinstance(v, dict) else v.cpu().numpy())
                      for k, v in tree.items()}
    out = t(tool.make_batch(0, batch, utd, size, device="cpu"))
    rng = np.random.default_rng(2)
    out["next_observations"] = t(tool.make_batch(1, batch, utd, size, device="cpu"))["observations"]
    out["rewards"] = rng.uniform(size=out["rewards"].shape).astype(np.float32)
    out["masks"] = (rng.uniform(size=out["masks"].shape) > 0.2).astype(np.float32)
    return out


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def keep_pattern(shape) -> np.ndarray:
    """A fixed keep-mask for `shape` (90% kept), the same in both packages."""
    rng = np.random.default_rng(int(np.prod(shape)) % (2 ** 31) + len(shape))
    return rng.uniform(size=tuple(shape)) < 0.9


class _PatternDropout:
    """flax.linen.stochastic's `random` with bernoulli answering keep_pattern."""

    def __getattr__(self, name):
        return getattr(jax.random, name)

    @staticmethod
    def bernoulli(key, p, shape):
        return jnp.asarray(keep_pattern(shape))


def _float32_encoders(monkeypatch):
    jax_small, torch_small = jax_encoders.SmallEncoder, torch_encoders.SmallEncoder
    monkeypatch.setattr(jax_encoders, "SmallEncoder",
                        lambda **kw: jax_small(**{**kw, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(torch_encoders, "SmallEncoder",
                        lambda **kw: torch_small(**{**kw, "compute_dtype": torch.float32}))


def _agents(jtool, variant, batch, **kw):
    """(JAX agent, port agent with the JAX agent's params grafted)."""
    jagent = jtool.make_agent(variant, _tree(jnp.asarray, batch), **kw)
    tagent = tool.make_agent(variant, _tree(torch.from_numpy, batch), seed=1, **kw)
    params = jax.tree.map(np.asarray, jax.device_get(jagent.state.params))
    target = jax.tree.map(np.asarray, jax.device_get(jagent.state.target_params))
    for a, b in zip(jax.tree.leaves(target["critic"]), jax.tree.leaves(params["critic"])):
        np.testing.assert_array_equal(a, b)  # JAX's target starts as the critic's copy
    load_sac_params(tagent, params)
    with torch.no_grad():
        for t, p in zip(tagent.state.target_params["critic"], tagent.state.params["critic"]):
            t.copy_(p)
    return jagent, tagent


def variant_parity(jtool, monkeypatch, variant: str, batch_size: int, utd: int, size: int,
                   **kw) -> dict:
    """The checks of the module docstring for one lever; returns the
    measured differences."""
    batch = parity_batch(batch_size, utd, size)
    n = batch_size * utd
    out = {}

    # the features at the variant's own compute dtype
    jagent, tagent = _agents(jtool, variant, batch, **kw)
    obs = batch["observations"]
    want = jax.jit(lambda p, o: jagent._encode(p, o, train=False))(
        jagent.state.params["critic"], _tree(jnp.asarray, obs))
    with torch.no_grad():
        got = tagent._encode(_tree(torch.from_numpy, obs))
    dtype = next(iter(tagent.encoder.encoders.values())).compute_dtype
    err = np.abs(got.numpy() - np.asarray(want))
    atol, mean = FEATURE_TOL[dtype]
    assert got.shape == want.shape == (n, tagent.encoder.out_features)
    assert err.max() <= atol and err.mean() <= mean, (variant, kw, dtype, err.max(), err.mean())
    out["features"] = (str(dtype), float(err.max()), float(err.mean()))

    # one update, the convolutions in float32 in both packages
    if dtype != torch.float32:
        _float32_encoders(monkeypatch)
        jagent, tagent = _agents(jtool, variant, batch, **kw)
    key = jagent.state.rng
    monkeypatch.setattr(stochastic, "random", _PatternDropout())
    _, jinfo = jagent.update_high_utd(_tree(jnp.asarray, batch), utd_ratio=utd)
    offsets, rng = jax_augment_draws(key, n)
    updates = jax_high_utd_draws(rng, n, utd, ensemble=ENSEMBLE, subsample=SUBSAMPLE,
                                 action_dim=tool.ACTION_DIM)
    for i, draws in enumerate(updates):
        rows, groups = (n // utd, ("critic",)) if i < utd else (n, ("actor", "temperature"))
        shapes = encoder_dropout_shapes(tagent.encoder, rows)
        for group in groups:
            for name in PASSES[group]:
                draws[f"{name}_dropout"] = {k: torch.from_numpy(keep_pattern(s))
                                            for k, s in shapes.items()}
    assert shapes, "the learned-embedding head draws dropout masks"
    _, info = tagent.update_high_utd(
        _tree(torch.from_numpy, batch), utd_ratio=utd,
        draws={"augment": offsets if tagent.config.augment else {}, "updates": updates})
    for group in ("critic", "actor", "temperature"):
        for k, v in jinfo[group].items():
            atol = LOSS_ATOL if k.endswith("_loss") else INFO_ATOL
            np.testing.assert_allclose(float(info[group][k]), float(v), rtol=LOSS_RTOL,
                                       atol=atol, err_msg=f"{variant} {kw} {group} {k}")
    out["losses"] = {g: {k: float(info[g][k]) for k in jinfo[g]} for g in ("critic", "actor")}
    return out
