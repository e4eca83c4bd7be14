"""Behaviour cloning, the static dataset and `evaluate_batched` against
serl_tpu's, on the CPU.

- `BCAgent` (no encoder; bc_policy.py's policy at width 32: tanh, no
  LayerNorm, an "exp" std in [1e-5, 5], no tanh squash), its perturbed flax
  params and its learner state after two JAX updates (mid-run Adam moments)
  carried into the port: one `update` (actor_loss and mse 1e-5 relative;
  params and moments 2e-6 abs), `sample_actions` (the mode; a draw with
  JAX's own standard-normal noise) and `get_debug_metrics` (1e-5 abs). The
  MLP without LayerNorm takes the plain Dense + tanh route: K5 is never
  called.
- `Dataset.sample_jax` with JAX's indices gathers JAX's rows exactly.
- `evaluate_batched` over a small lockstep env written in both frameworks
  (the same dynamics), the grafted BC agent acting by its mode: the
  return mean, return std and success rate, 1e-5 abs.
- The record_demo and bc_policy examples: their flags and defaults, and
  both main()s on the CPU at a tiny size.
- `BCAgent.create(encoder_type="resnet-pretrained")` with
  `SERL_RESNET10_PARAMS` at the committed pickle: every backbone tensor
  holds the pickle's float16 value cast to fp32 (kernels HWIO -> OIHW),
  exactly, and an update leaves it so. The JAX package's BC graft looks up
  `encoder_<key>` where flax names the ObsEncoder's dict `encoders_<key>`
  (`serl_tpu/agents/bc.py:187`), so JAX raises a KeyError whenever the
  pickle is found; the port grafts under flax's name (the inherited quirk
  is not carried over, it cannot be: JAX has no grafted agent to match).
"""

from pathlib import Path

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.bc import BCAgent as JaxBCAgent
from serl_tpu.common import evaluation as jevaluation
from serl_tpu.data.dataset import Dataset as JaxDataset
from serl_tpu_torch.agents.bc import BCAgent
from serl_tpu_torch.common.evaluation import evaluate_batched
from serl_tpu_torch.data.dataset import Dataset
from serl_tpu_torch.examples import bc_policy, record_demo
from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from serl_tpu_torch.networks import mlp
from serl_tpu_torch.utils.jax_params import actor_pairs, load_pairs, pairs_to_tree, resnet_pairs
from serl_tpu_torch.utils.pretrained import read_params
from tests.test_torch_learner import jax_state_np

OBS, ACT, H = 10, 4, 32
NET = {"activations": jax.nn.tanh, "use_layer_norm": False, "hidden_dims": (H, H)}
POLICY = {"tanh_squash_distribution": False, "std_parameterization": "exp", "std_min": 1e-5,
          "std_max": 5.0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": rng.normal(size=(n, OBS)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, ACT)).astype(np.float32)}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_agent():
    return BCAgent.create(torch.zeros(1, OBS), torch.zeros(1, ACT),
                          network_kwargs={**NET, "activations": "tanh"}, policy_kwargs=POLICY,
                          generator=torch.Generator().manual_seed(0), device="cpu")


def _load(agent, state):
    """A JAX BC learner state (jax_state_np's layout) into the port agent."""
    pairs = actor_pairs(agent.actor)
    load_pairs(pairs, state["params"])
    index = {id(p): i for i, p in enumerate(agent.state.params["actor"])}
    opt, src = agent.state.opt_states["actor"], state["opt_states"]["actor"]
    for tree, target in ((src["mu"], opt.mu), (src["nu"], opt.nu)):
        load_pairs([(path[1:], target[index[id(t)]], layout) for path, t, layout in pairs], tree)
    opt.count, opt.learning_rate = src["count"], src["learning_rate"]


@pytest.fixture(scope="module")
def agents():
    jagent = JaxBCAgent.create(jax.random.PRNGKey(0), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)),
                               network_kwargs=NET, policy_kwargs=POLICY)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rng.normal(size=x.shape))
                          .astype(np.float32), jax.device_get(jagent.state.params))
    jagent = jagent.replace(state=jagent.state.replace(params=jax.tree.map(jnp.asarray, params)))
    for i in range(2):
        jagent, _ = jagent.update(_jb(_batch(16, 10 + i)))
    return jagent, jax_state_np(jagent)


def test_torch_bc_update_and_sampling_match_jax(agents, monkeypatch):
    jagent, state = agents
    agent = _port_agent()
    _load(agent, state)
    calls = []
    monkeypatch.setattr(mlp, "dense_layer_norm_tanh", lambda *a, **kw: calls.append(a))
    monkeypatch.setattr(k5, "dense_layer_norm_tanh", lambda *a, **kw: calls.append(a))
    batch = _batch(16, 3)
    obs = torch.from_numpy(batch["observations"])
    np.testing.assert_allclose(agent.sample_actions(obs, argmax=True).numpy(),
                               np.asarray(jagent.sample_actions(_jb(batch)["observations"],
                                                                argmax=True)), atol=1e-5, rtol=0)
    key = jax.random.PRNGKey(4)
    want = jagent.sample_actions(_jb(batch)["observations"], seed=key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (16, ACT))))
    np.testing.assert_allclose(agent.sample_actions(obs, noise=noise).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    got_dbg, want_dbg = agent.get_debug_metrics(_tb(batch)), jagent.get_debug_metrics(_jb(batch))
    for k in ("mse", "log_probs", "pi_actions"):
        np.testing.assert_allclose(got_dbg[k].numpy(), np.asarray(want_dbg[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    jnew, jinfo = jagent.update(_jb(batch))
    _, info = agent.update(_tb(batch))
    for k in ("actor_loss", "mse"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]), rtol=1e-5, err_msg=k)
    got = pairs_to_tree(actor_pairs(agent.actor))
    want = jax.device_get(jnew.state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), atol=2e-6, rtol=0),
                 got, want)
    mu = jax_state_np(jnew)["opt_states"]["actor"]["mu"]
    index = {id(p): i for i, p in enumerate(agent.state.params["actor"])}
    for path, t, layout in actor_pairs(agent.actor):
        node = mu
        for key_ in path[1:]:
            node = node[key_]
        value = agent.state.opt_states["actor"].mu[index[id(t)]]
        value = value.T if layout == "T" else value
        np.testing.assert_allclose(value.numpy(), node, atol=2e-6, rtol=1e-5)
    assert agent.state.opt_states["actor"].count == 3
    assert calls == []  # no LayerNorm: the plain Dense + tanh, never K5


def test_torch_bc_create_defaults_and_no_encoder():
    agent = BCAgent.create(torch.zeros(1, OBS), torch.zeros(1, ACT), device="cpu")
    assert not agent.actor.tanh_squash and agent.actor.std_parameterization == "exp"
    assert agent.actor.trunk.norms is None and agent.actor.std_max == 10.0
    assert agent.state.txs["actor"].learning_rate == 3e-4
    assert agent.encoder is None and agent.image_keys == ()
    # with image keys the policy reads an encoder (tests/test_torch_agents_rest.py)
    pixels = BCAgent.create({"state": torch.zeros(1, OBS),
                             "front": torch.zeros((1, 1, 32, 32, 3), dtype=torch.uint8)},
                            torch.zeros(1, ACT), image_keys=("front",), device="cpu")
    assert pixels.encoder is not None and list(pixels.state.params) == ["actor"]


def test_torch_bc_resnet_pretrained_holds_the_committed_backbone(monkeypatch):
    pkl = Path(__file__).resolve().parents[1] / "resnet10_params.pkl"
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(pkl))
    rng = np.random.default_rng(3)
    obs = {"state": rng.normal(size=(4, 7)).astype(np.float32),
           "image": rng.integers(0, 256, (4, 1, 64, 64, 3)).astype(np.uint8)}
    actions = rng.uniform(-1, 1, (4, ACT)).astype(np.float32)
    agent = BCAgent.create(_tb(obs), torch.from_numpy(actions), encoder_type="resnet-pretrained",
                           image_keys=("image",), generator=torch.Generator().manual_seed(0),
                           device="cpu")
    raw = read_params(str(pkl))
    backbone = agent.encoder.encoders["image"].pretrained_encoder

    def check():
        for path, tensor, layout in resnet_pairs(backbone):
            node = raw
            for k in path:
                node = node[k]
            want = torch.from_numpy(node.astype(np.float32))
            want = want.permute(3, 2, 0, 1) if layout == "HWIO" else want
            assert tensor.dtype == torch.float32 and torch.equal(tensor.detach(), want), path

    check()
    assert sorted({p[0] for p, _, _ in resnet_pairs(backbone)}) == sorted(raw)
    features = agent.encoder(_tb(obs))
    assert bool(torch.isfinite(features).all())
    _, info = agent.update({"observations": _tb(obs), "actions": torch.from_numpy(actions)},
                           draws={"encoder_dropout": {"image": torch.ones(
                               (4, agent.encoder.encoders["image"].dropout_features),
                               dtype=torch.bool)}})
    assert math.isfinite(float(info["actor_loss"]))
    check()  # the encoder is never trained
    with pytest.raises(KeyError, match="encoder_image"):  # the JAX package's misnamed graft
        JaxBCAgent.create(jax.random.PRNGKey(0), obs, actions, encoder_type="resnet-pretrained",
                          image_keys=("image",))


def test_torch_dataset_sample_jax_takes_jax_indices():
    rng = np.random.default_rng(5)
    data = {"observations": rng.normal(size=(37, OBS)).astype(np.float32),
            "actions": rng.normal(size=(37, ACT)).astype(np.float32),
            "next": {"x": np.arange(37, dtype=np.int32)}}
    jds, ds = JaxDataset(data), Dataset(data, device="cpu")
    assert ds.size == jds.size == 37
    key = jax.random.PRNGKey(6)
    want = jds.sample_jax(key, 9)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (9,), 0, 37))).long()
    got = ds.sample_jax(9, indices=idx)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)), got, want)
    drawn = ds.sample_jax(9, generator=torch.Generator().manual_seed(0))
    assert drawn["actions"].shape == (9, ACT)


class TorchToyEnv:
    """A lockstep env: the state moves by 0.1 x the action's first OBS
    coordinates (tiled), reward -|state|_1 / OBS, success where state[0] > 0.05."""

    def __init__(self, start):
        self.start, self.device = torch.from_numpy(start), torch.device("cpu")

    def reset(self, n, generator=None):
        s = self.start[:n].clone()
        return s, {"state": {"x": s}}

    def step(self, s, a):
        s = s + 0.1 * a.repeat(1, OBS // ACT + 1)[:, :OBS]
        r = -s.abs().mean(-1)
        return s, {"state": {"x": s}}, r, torch.zeros_like(r), {"success": (s[:, 0] > 0.05).float()}


class JaxToyEnv:
    def __init__(self, start):
        self.start = jnp.asarray(start)

    def reset(self, key):  # one env: the start row its key indexes
        s = self.start[key[1] % self.start.shape[0]]
        return s, {"state": {"x": s}}

    def step(self, s, a):
        s = s + 0.1 * jnp.tile(a, OBS // ACT + 1)[:OBS]
        r = -jnp.abs(s).mean(-1)
        return s, {"state": {"x": s}}, r, jnp.zeros_like(r), {"success": (s[0] > 0.05) * 1.0}


def test_torch_evaluate_batched_matches_jax(agents):
    jagent, state = agents
    agent = _port_agent()
    _load(agent, state)
    n, length = 6, 5
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, n + 1)[1:]
    start = np.zeros((n, OBS), np.float32)
    start_rows = np.random.default_rng(8).normal(scale=0.1, size=(n, OBS)).astype(np.float32)
    start[:] = start_rows[np.asarray(keys[:, 1]) % n]  # the row each JAX key picks
    jstats = jevaluation.evaluate_batched(JaxToyEnv(start_rows), jagent, rng, num_episodes=n,
                                          episode_len=length)
    stats = evaluate_batched(TorchToyEnv(start), agent, num_episodes=n, episode_len=length)
    assert set(stats) == {"return_mean", "return_std", "success_rate"}
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, atol=1e-5, rtol=0, err_msg=k)
    assert 0.0 < stats["success_rate"] < 1.0
    drawn = evaluate_batched(TorchToyEnv(start), agent, torch.Generator().manual_seed(0),
                             num_episodes=n, episode_len=length, argmax=False)
    assert np.isfinite(drawn["return_mean"])


def test_torch_record_demo_and_bc_policy_flags():
    args = record_demo.parser().parse_args([])
    assert (args.num_demos, args.out, args.pixels, args.noise, args.seed) == (
        20, "demos.pkl", False, 0.02, 0)
    args = bc_policy.parser().parse_args(["--demo_path", "d.pkl"])
    assert (args.steps, args.batch_size, args.eval_episodes, args.seed) == (10_000, 256, 32, 0)
    assert bc_policy.NETWORK_KWARGS == {"activations": "tanh", "use_layer_norm": False,
                                        "hidden_dims": (256, 256)}
    assert bc_policy.POLICY_KWARGS["std_max"] == 5.0 and bc_policy.EVAL_SEED == 99


def test_torch_record_demo_then_bc_policy_on_the_cpu(tmp_path, capsys):
    """The two entry points through their main(): 2 successful expert demos
    of the pick env saved as numpy arrays (the JAX package's demo format),
    then BC on them and a 2-episode evaluation."""
    path = str(tmp_path / "demos.pkl")
    record_demo.main(["--device", "cpu", "--num_demos", "2", "--out", path])
    with open(path, "rb") as f:
        trs = pickle.load(f)
    assert isinstance(trs["observations"], np.ndarray) and trs["observations"].shape == (200, OBS)
    assert trs["success"].reshape(2, 100).max(1).min() == 1.0  # both demos succeed
    stats = bc_policy.main(["--device", "cpu", "--demo_path", path, "--steps", "20",
                            "--batch_size", "32", "--eval_episodes", "2"])
    assert set(stats) == {"return_mean", "return_std", "success_rate"}
    assert np.isfinite(stats["return_mean"])
    out = capsys.readouterr().out
    assert "saved 200 transitions (2 successful demos)" in out and "dataset: 200 transitions" in out
