"""CUDA graphs of `SACAgent.update` (serl_tpu_torch/agents/graphs.py) against
the eager step, on the card (marker `cuda`: each test skips without one),
and on the CPU the parts of agents/graphs.py that run there:

  * what a replay runs (the step on device scalars, then `advance`) is the
    eager `update` bit for bit;
  * K5's counts of a block kept apart, then added as a replay adds them.

On the card:

Every test builds two agents with the same weights and feeds them the same
batches and draws: one takes the graph path, its twin runs each update under
a pass-through dispatch mode, which agents/graphs.py observes and runs eager.
The agents' optimizers take no warmup (lr 3e-4 from the first step), so
that the steps move the params.

  * 3 `update_high_utd` calls (15 updates) of a small DrQ agent, a
    "resnet-pretrained" DrQ agent (the committed resnet10_params.pkl) and a
    state SAC agent: params, Adam moments, targets and every update's infos
    are the twin's bit for bit (an eager step and a replay run the same
    kernels on the same scalars); 2 captures and 13 replays (each key's
    first step eager), counted by the graphs and by the `learner.capture` /
    `learner.replay` spans; the four critic minibatches' infos differ (each
    replay's outputs are cloned out); K5's host counts are the twin's.
  * Two agents from one state, one after 2 of 3 calls made by the other
    (a run resumed from a checkpoint, whose first step of each key runs
    eager where the other replays) end bit for bit equal.
  * A swapped optimizer state (new moment tensors) captures anew, and the old
    tensors are not written again.
  * A data-parallel handle keeps the eager path.
  * A loss that syncs with the host cannot be captured: a warning, the key
    kept in `failed`, its steps eager from then on, the other key graphed.
"""

import warnings
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from serl_tpu_torch.agents import graphs
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.common.optimizers import device_scalars
from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from serl_tpu_torch.utils import timer

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("front", "wrist")
SIZE, BATCH, UTD = 64, 64, 4
OPTIMIZER = {"learning_rate": 3e-4}  # no warmup: the first steps move the params


class _Eager(TorchDispatchMode):
    """Passes every op through; its presence makes `update` run eager."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU mode")
    monkeypatch.setenv("SERL_RESNET10_PARAMS", str(ROOT / "resnet10_params.pkl"))
    timer.disable()
    timer.clear()
    yield torch.device("cuda")
    timer.disable()
    timer.clear()


def _agent(kind: str, device):
    from serl_tpu_torch.training.launcher import make_drq_agent, make_sac_agent

    if kind == "state":
        agent = make_sac_agent(0, device=device)
    else:
        sample = {"state": torch.zeros((1, 7)),
                  **{k: torch.zeros((1, 1, SIZE, SIZE, 3), dtype=torch.uint8) for k in KEYS}}
        agent = make_drq_agent(0, sample, torch.zeros((1, 4)), image_keys=KEYS,
                               encoder_type=kind, device=device)
    return agent.init_train_state(OPTIMIZER, OPTIMIZER, OPTIMIZER)


def _batch(kind: str, g, device):
    def obs():
        if kind == "state":
            return torch.randn((BATCH, 10), generator=g, device=device)
        out = {"state": torch.randn((BATCH, 7), generator=g, device=device)}
        for k in KEYS:
            out[k] = torch.randint(0, 256, (BATCH, 1, SIZE, SIZE, 3), generator=g, device=device,
                                   dtype=torch.uint8)
        return out

    return {"observations": obs(), "next_observations": obs(),
            "actions": torch.rand((BATCH, 4), generator=g, device=device) * 1.9 - 0.95,
            "rewards": torch.randn((BATCH,), generator=g, device=device),
            "masks": (torch.rand((BATCH,), generator=g, device=device) > 0.1).float(),
            "dones": torch.zeros((BATCH,), device=device)}


def _draws(agent, kind, batch, g):
    if kind == "state":
        return agent.high_utd_draws(BATCH, UTD, g)
    return agent.drq_draws(batch, UTD, g)


def _recording(agent):
    """Keeps each `update`'s infos in the returned list."""
    infos, update = [], agent.update

    def recorded(*args, **kw):
        out = update(*args, **kw)
        infos.append(out[1])
        return out

    agent.update = recorded
    return infos


def _call(agent, batch, draws, eager: bool):
    if eager:
        with _Eager():
            return agent.update_high_utd(batch, utd_ratio=UTD, draws=draws)
    return agent.update_high_utd(batch, utd_ratio=UTD, draws=draws)


def _state_tensors(agent):
    s = agent.state
    out = {f"{g}.param{i}": p for g, ps in s.params.items() for i, p in enumerate(ps)}
    for g, o in s.opt_states.items():
        out.update({f"{g}.mu{i}": t for i, t in enumerate(o.mu)})
        out.update({f"{g}.nu{i}": t for i, t in enumerate(o.nu)})
    out.update({f"{g}.target{i}": t for g, ts in s.target_params.items() for i, t in enumerate(ts)})
    return out


def _change_gap(a: torch.Tensor, b: torch.Tensor, start: torch.Tensor) -> float:
    """|(a - start) - (b - start)| / |b - start|: how far the graphed change
    of a tensor is from the eager one (0 where both are equal)."""
    a, b, start = a.detach().double(), b.detach().double(), start.detach().double()
    diff, scale = (a - b).norm().item(), (b - start).norm().item()
    return diff if scale == 0.0 else diff / scale


def _info_leaves(info, prefix=""):
    for k, v in info.items():
        if isinstance(v, dict):
            yield from _info_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_twins(graphed, eager, infos_g, infos_e, start):
    """The graphed agent's tensors and infos are the eager twin's bit for
    bit; the message gives the relative gaps of the tensors' changes from
    `start` (each tensor before the first step) where they are not."""
    tg, te = _state_tensors(graphed), _state_tensors(eager)
    differ = [n for n in te if not torch.equal(tg[n], te[n])]
    gaps = sorted(((_change_gap(tg[n], te[n], start[n]), n) for n in differ), reverse=True)
    assert not differ, (len(differ), len(te), gaps[:8])
    assert any(not torch.equal(te[n], start[n]) for n in te if ".param" in n)  # the steps moved
    assert len(infos_g) == len(infos_e)
    for i, (a, b) in enumerate(zip(infos_g, infos_e)):
        la, lb = dict(_info_leaves(a)), dict(_info_leaves(b))
        assert la.keys() == lb.keys()
        for n, v in lb.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(la[n], v), (i, n, la[n], v)
            else:  # the learning rates, host floats
                assert la[n] == v, (i, n)
    assert graphed.state.step == eager.state.step
    assert ({g: (o.count, o.learning_rate) for g, o in graphed.state.opt_states.items()}
            == {g: (o.count, o.learning_rate) for g, o in eager.state.opt_states.items()})


def _start(agent):
    return {n: t.detach().clone() for n, t in _state_tensors(agent).items()}


def _launches():
    return (k5.dense_layer_norm_tanh_forward.launches, k5.dense_layer_norm_tanh_backward.launches)


@pytest.fixture
def cpu_step(monkeypatch):
    """A state agent on the CPU, a batch, the draws of a critic step and the
    step on device scalars then `advance` (what a replay runs), as a
    callable."""
    monkeypatch.setattr(k5, "shape_log", None)
    monkeypatch.setattr(k5, "flops", None)
    g = torch.Generator().manual_seed(0)
    agent = _agent("state", torch.device("cpu"))
    batch = _batch("state", g, "cpu")
    networks = frozenset({"critic"})
    draws = agent.update_draws(BATCH, networks, g)

    def replayed():
        rows = agent.state.step_scalars()
        info = agent._step(batch, draws, networks,
                           device_scalars(list(rows.values()), torch.device("cpu")))
        agent.state.advance(rows)
        return info

    return agent, batch, draws, networks, replayed


def test_torch_replayed_step_is_the_eager_update_bit_for_bit(cpu_step):
    agent, batch, draws, networks, replayed = cpu_step
    twin = _agent("state", torch.device("cpu"))
    start = _start(agent)
    for _ in range(3):
        info = replayed()
        _, want = twin.update(batch, networks_to_update=networks, draws=draws)
        for n, v in _info_leaves({g: i for g, i in want.items() if isinstance(i, dict)}):
            assert torch.equal(dict(_info_leaves(info))[n], v), n
    ta, tb = _state_tensors(agent), _state_tensors(twin)
    assert all(torch.equal(ta[n], tb[n]) for n in ta)
    assert agent.state.step == twin.state.step == 3
    assert ({g: (o.count, o.learning_rate) for g, o in agent.state.opt_states.items()}
            == {g: (o.count, o.learning_rate) for g, o in twin.state.opt_states.items()})
    assert not torch.equal(ta["critic.param0"], start["critic.param0"])  # the steps moved it


def test_torch_counts_kept_apart_are_added_as_a_replay_adds_them(cpu_step):
    agent, _, _, _, replayed = cpu_step
    k5.shape_log, k5.flops = set(), 0
    launches = _launches()
    with k5.counts_apart() as counts:
        replayed()
        k5.dense_layer_norm_tanh_forward.launches += 3  # what a card's launches add
        k5.dense_layer_norm_tanh_backward.launches += 2
        k5.flops += 7
    assert (_launches(), k5.shape_log, k5.flops) == (launches, set(), 0)
    assert (counts.forward, counts.backward, counts.flops) == (3, 2, 7)
    shapes = set(counts.shapes)
    assert shapes and all(len(s) in (5, 7) for s in shapes)  # calls and backwards
    assert len(counts.shapes) > len(shapes)  # one entry a call
    for _ in range(2):
        counts.add()
    assert _launches() == (launches[0] + 6, launches[1] + 4)
    assert (k5.shape_log, k5.flops) == (shapes, 14)
    k5.shape_log = k5.flops = None
    counts.add()  # nothing logs or tallies: the launches alone
    assert _launches() == (launches[0] + 9, launches[1] + 6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["small", "resnet-pretrained", "state"])
def test_torch_graphed_update_high_utd_matches_eager(card, kind):
    graphed, eager = _agent(kind, card), _agent(kind, card)
    infos_g, infos_e = _recording(graphed), _recording(eager)
    g = torch.Generator(device=card).manual_seed(3)
    calls = []
    for _ in range(3):
        batch = _batch(kind, g, card)
        calls.append((batch, _draws(graphed, kind, batch, g)))
    start, counted = _start(graphed), []
    for agent, eager_mode in ((eager, True), (graphed, False)):
        before = _launches()
        if not eager_mode:
            timer.enable()
        for batch, draws in calls:
            _call(agent, batch, draws, eager_mode)
        timer.disable()
        torch.cuda.synchronize()
        counted.append(tuple(b - a for a, b in zip(before, _launches())))
    assert counted[0] == counted[1] and counted[0][0] > 0  # a replay counts K5's launches
    assert (graphed.graphs.captures, graphed.graphs.replays, graphed.graphs.failed) == (2, 13, {})
    assert (eager.graphs.captures, eager.graphs.replays, eager.graphs.graphs) == (0, 0, {})
    names = [r.name for r in timer.records()]
    assert (names.count("learner.capture"), names.count("learner.replay"),
            names.count("learner.critic"), names.count("learner.actor")) == (2, 13, 12, 3)
    critic_losses = [float(i["critic"]["critic_loss"]) for i in infos_g[:UTD]]
    assert len(set(critic_losses)) == UTD, critic_losses  # four minibatches, four losses
    _assert_twins(graphed, eager, infos_g, infos_e, start)


@pytest.mark.cuda
def test_torch_swapped_optimizer_state_captures_anew(card):
    graphed, eager = _agent("small", card), _agent("small", card)
    infos_g, infos_e = _recording(graphed), _recording(eager)
    start = _start(graphed)
    g = torch.Generator(device=card).manual_seed(4)
    for call in range(4):
        batch = _batch("small", g, card)
        draws = _draws(graphed, "small", batch, g)
        if call == 2:  # a restore that brings new moment tensors
            old = graphed.state.opt_states["critic"].mu
            kept = [t.clone() for t in old]
            for agent in (graphed, eager):
                s = agent.state.opt_states["critic"]
                s.mu = [t.clone() for t in s.mu]
        _call(eager, batch, draws, True)
        _call(graphed, batch, draws, False)
    torch.cuda.synchronize()
    # the critic and the actor graphs both step the critic group: both anew, without an eager
    # step (each key's first step ran eager in the first two calls)
    assert (graphed.graphs.captures, graphed.graphs.replays) == (4, 18)
    assert all(torch.equal(a, b) for a, b in zip(old, kept))  # no replay wrote the old ones
    _assert_twins(graphed, eager, infos_g, infos_e, start)


class _OneRank:
    """A data-parallel handle of one rank: every mean is the value itself."""

    world_size = 1

    def all_reduce_mean(self, tensors):
        return list(tensors)

    def all_reduce_sum_(self, tensor):
        return tensor


@pytest.mark.cuda
def test_torch_data_parallel_handle_keeps_the_eager_path(card):
    agent = _agent("state", card)
    agent.state.dp = _OneRank()
    g = torch.Generator(device=card).manual_seed(5)
    batch = _batch("state", g, card)
    for _ in range(3):
        agent.update(batch, draws=agent.update_draws(BATCH, generator=g))
    assert (agent.graphs.captures, agent.graphs.replays, agent.graphs.graphs) == (0, 0, {})
    assert agent.state.step == 3


class _SyncingAgent(SACAgent):
    def critic_loss_fn(self, batch, draws):
        loss, info = super().critic_loss_fn(batch, draws)
        info["critic_loss_on_host"] = torch.tensor(float(loss))  # waits for the card
        return loss, info


@pytest.mark.cuda
def test_torch_a_loss_that_cannot_be_captured_runs_eager(card):
    graphed, eager = _agent("state", card), _agent("state", card)
    graphed.__class__ = eager.__class__ = _SyncingAgent
    infos_g, infos_e = _recording(graphed), _recording(eager)
    start = _start(graphed)
    g = torch.Generator(device=card).manual_seed(6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            batch = _batch("state", g, card)
            draws = _draws(graphed, "state", batch, g)
            _call(eager, batch, draws, True)
            _call(graphed, batch, draws, False)
    torch.cuda.synchronize()
    assert any("capture failed" in str(w.message) for w in caught)
    failed = list(graphed.graphs.failed.values())
    assert len(failed) == 1 and graphed.graphs.captures == 1, failed  # the critic's; the actor's
    assert graphed.graphs.replays == 2  # the actor's second and third steps
    _assert_twins(graphed, eager, infos_g, infos_e, start)


@pytest.mark.cuda
def test_torch_a_resumed_agent_continues_bit_for_bit(card):
    """What a checkpoint's pause and resume does: a second agent takes the
    first's state after 2 calls and makes the third; both end equal."""
    first, resumed = _agent("small", card), _agent("small", card)
    g = torch.Generator(device=card).manual_seed(7)
    calls = []
    for _ in range(3):
        batch = _batch("small", g, card)
        calls.append((batch, _draws(first, "small", batch, g)))
    for batch, draws in calls[:2]:
        _call(first, batch, draws, False)
    with torch.no_grad():
        for a, b in zip(_state_tensors(resumed).values(), _state_tensors(first).values()):
            a.copy_(b)
    resumed.state.step = first.state.step
    for name, s in first.state.opt_states.items():
        r = resumed.state.opt_states[name]
        r.count, r.learning_rate = s.count, s.learning_rate
    for agent in (first, resumed):
        _call(agent, *calls[2], False)
    torch.cuda.synchronize()
    assert resumed.graphs.replays == 3 and first.graphs.replays == 13
    tf, tr = _state_tensors(first), _state_tensors(resumed)
    differ = [n for n in tf if not torch.equal(tf[n], tr[n])]
    assert not differ, differ
