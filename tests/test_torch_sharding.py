"""The port's data parallelism (serl_tpu_torch/distributed/sharding.py) on
the CPU: two gloo ranks, spawned once for the module (tests/torch_dp.py
holds what they run).

  (a) the layout specs equal the JAX package's on every field both have; an
      undeclared carry field, and envs or streams that do not divide over
      the ranks, raise;
  (b) one update_high_utd over two ranks, each given only its streams' rows
      (its exchange hands it its share of each minibatch), against JAX's
      single-device update on the global stream-major batch with JAX's
      draws: plain SAC, the RLPD interleave, SAC with the Q-filtered BC
      term, and DrQ with its crop offsets. Params and optimizer state equal
      bit for bit on both ranks, and within test_torch_update_high_utd_
      matches_jax's 2e-6 of JAX's; the collectives counted exactly;
  (c) the state loop at 8 envs on two ranks against the 1-rank loop at the
      same seed: env states, ring contents and learner state equal bit for
      bit up to the first update (random actions until then), the gate on
      the same iteration, within LOOP_ATOL after four updating iterations;
      the episode counts exact and the summed statistics within 1e-6; the
      inserts issue no collective; the collectives counted exactly;
  (d) the chained fwbw loop at the JAX dry run's size: both learners open on
      the same iteration on both ranks and in the 1-rank run (random actions
      throughout, so both route the same transitions), each
      transition routed once (the routed rows sum to iters x N).
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serl_tpu.distributed.sharding as jax_sharding
from serl_tpu.agents.drq import DrQAgent as JaxDrQAgent
from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu.vision.encoders import SmallEncoder as JaxSmallEncoder
from serl_tpu_torch.distributed import sharding
from serl_tpu_torch.examples.dryrun_multichip import launch, run_program
from serl_tpu_torch.training.launcher import make_state_sim_experiment
from tests import torch_dp
from tests.test_torch_drq import jax_augment_draws
from tests.test_torch_learner import (
    assert_states_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.torch_ports import next_port_pair

WORLD = 2
FORMS = ("sac", "rlpd", "bc", "drq")
UTD = {"sac": 4, "rlpd": 4, "bc": 4, "drq": 2}
BATCH = {"sac": 32, "rlpd": 32, "bc": 32, "drq": 8}
# (c): 8 envs, batch 8 x UTD 2, gate and random actions at 16 rows (the
# second iteration), then 4 iterations with updates
LOOP = dict(num_envs=8, batch_size=8, utd_ratio=2, updates_per_iter=1, training_starts=16,
            random_steps=16, buffer_capacity=8 * 16)
LOOP_SEGMENTS = [1, 4]
# after the first update: the all-reduce sums each group's gradients in
# another order than one rank's mean over the whole minibatch, so the
# policies differ in their last bits and the loop carries that on; measured
# after the four updating iterations: params 2.0e-8, ring 1.5e-8, env
# states 0; with the exchange left out (a planted local minibatch split)
# the env states differ by 0.109 (the learning rate warms up from 0 over
# 2,000 steps, so the steps are small; (b) holds one update at a full step)
LOOP_ATOL = 1e-6
# (d): the JAX dry run's fwbw size; random actions throughout, so the 1-rank
# and 2-rank runs route the same transitions
FWBW = dict(overrides=dict(random_steps=1000), segments=[7])


def _tree(fn, t):
    return torch_dp.tree(fn, t)


def _synthetic_mid(jstate, seed):
    """JAX's learner state with perturbed params, the target apart, and
    mid-run Adam moments (a first step from zero moments is ill-conditioned:
    tests/test_torch_learner.py)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    st = dict(jstate)
    st["params"] = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(f32),
                                jstate["params"])
    st["target_params"] = jax.tree.map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(f32),
        {"critic": st["params"]["critic"]})
    st["step"] = 10
    st["opt_states"] = {g: dict(o, count=10,
                                mu=jax.tree.map(lambda x: (1e-3 * rng.normal(size=x.shape)).astype(f32),
                                                o["mu"]),
                                nu=jax.tree.map(lambda x: (1e-6 * (1.0 + rng.uniform(size=x.shape))).astype(f32),
                                                o["nu"]))
                        for g, o in jstate["opt_states"].items()}
    return st


def _state_batch(n, seed):
    rng = np.random.default_rng(seed)
    o = torch_dp
    return {"observations": rng.normal(size=(n, o.OBS)).astype(np.float32),
            "actions": rng.uniform(-0.95, 0.95, (n, o.ACT)).astype(np.float32),
            "next_observations": rng.normal(size=(n, o.OBS)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": (rng.uniform(size=(n,)) > 0.2).astype(np.float32),
            "dones": np.zeros((n,), np.float32)}


def _pixel_obs(rng, n):
    o = torch_dp
    return {"state": rng.normal(size=(n, 7)).astype(np.float32),
            **{k: rng.integers(0, 256, (n, 1, o.DRQ_SIZE, o.DRQ_SIZE, 3)).astype(np.uint8)
               for k in o.DRQ_KEYS}}


def _pixel_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"observations": _pixel_obs(rng, n), "next_observations": _pixel_obs(rng, n),
            "actions": rng.uniform(-0.95, 0.95, (n, torch_dp.DRQ_ACT)).astype(np.float32),
            "rewards": rng.normal(size=(n,)).astype(np.float32),
            "masks": (rng.uniform(size=(n,)) > 0.2).astype(np.float32),
            "dones": np.zeros((n,), np.float32)}


def _interleave(a, b):
    return {k: np.stack([a[k], b[k]], 1).reshape((-1,) + a[k].shape[1:]) for k in a}


def _jax_agent(form, example_obs=None):
    o = torch_dp
    key = jax.random.PRNGKey(0)
    if form == "drq":
        encs = {k: JaxSmallEncoder(features=o.DRQ_FEATURES, bottleneck_dim=o.DRQ_BOTTLENECK,
                                   compute_dtype=jnp.float32, name=f"encoder_{k}")
                for k in o.DRQ_KEYS}
        return JaxDrQAgent.create_drq(key, _tree(jnp.asarray, example_obs),
                                      jnp.zeros((1, o.DRQ_ACT)), custom_encoders=encs,
                                      **o.agent_kwargs(jnp.tanh, discount=0.96,
                                                       image_keys=o.DRQ_KEYS))
    extra = {"bc_regularization": 0.5} if form == "bc" else {}
    return JaxSACAgent.create_states(key, jnp.zeros((1, o.OBS)), jnp.zeros((1, o.ACT)),
                                     **o.agent_kwargs(jnp.tanh, **extra))


def _parity_case(form):
    """(the ranks' case, the JAX agent and key that compute the reference)."""
    utd, n = UTD[form], BATCH[form]
    key = jax.random.PRNGKey(11 + FORMS.index(form))
    case = {"form": form, "utd": utd}
    if form == "drq":
        batch = _pixel_batch(n, 3)
        case["example_obs"] = _tree(lambda x: x[:1], batch["observations"])
        jagent = _jax_agent(form, case["example_obs"])
        offsets, rng = jax_augment_draws(key, n)
        case["draws"] = {"augment": offsets,
                         "updates": jax_high_utd_draws(rng, n, utd, ensemble=torch_dp.E,
                                                       subsample=torch_dp.S,
                                                       action_dim=torch_dp.DRQ_ACT)}
        case["batch"] = batch
    else:
        jagent = _jax_agent(form)
        case["draws"] = jax_high_utd_draws(key, n, utd, ensemble=torch_dp.E,
                                           subsample=torch_dp.S, action_dim=torch_dp.ACT)
        if form == "rlpd":
            # the online half stream-major over 4 streams (a rank holds 2),
            # the demo half replicated; JAX updates on their interleave
            case["online"], case["demo"] = _state_batch(n // 2, 4), _state_batch(n // 2, 5)
            batch = _interleave(case["online"], case["demo"])
        else:
            batch = case["batch"] = _state_batch(n, 4)
    case["state"] = _synthetic_mid(jax_state_np(jagent), 7)
    return case, (jagent, key, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results (started first, in a thread), JAX's updates and
    the 1-rank loops (computed here meanwhile)."""
    cases, refs = zip(*(_parity_case(form) for form in FORMS))
    snap = tmp_path_factory.mktemp("dp")
    ref_snap = tmp_path_factory.mktemp("one_rank")
    loop_runs = [("state", dict(overrides=LOOP, segments=LOOP_SEGMENTS)),
                 ("fwbw", FWBW)]
    out = {}

    def ranks():
        try:
            out["ranks"] = launch(torch_dp.Tasks(torch_dp.UpdateParity(list(cases)),
                                                 torch_dp.LoopRuns(loop_runs, str(snap))),
                                  WORLD, "cpu", "gloo", port=next_port_pair(), timeout_s=300)
        except Exception as exc:  # re-raised in the test thread below
            out["error"] = exc

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        jax_out = []
        for (jagent, key, batch), case in zip(refs, cases):
            jnew, jinfo = jax_with_state(jagent, case["state"], key).update_high_utd(
                _tree(jnp.asarray, batch), utd_ratio=case["utd"])
            jax_out.append((jax_state_np(jnew), jax.device_get(jinfo)))
        torch.set_num_threads(1)
        one = [run_program(name, None, "cpu", WORLD, False, snapshot_dir=str(ref_snap), **kw)
               for name, kw in loop_runs]
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    return {"cases": cases, "jax": jax_out, "ranks": out["ranks"], "one": one, "snap": snap,
            "ref_snap": ref_snap}


# ---------------------------------------------------------------- (a)


def _dp(rank=0, world=WORLD):
    return sharding.DataParallel(rank=rank, world_size=world, backend="gloo",
                                 device=torch.device("cpu"))


def test_torch_sharding_specs_match_jax():
    for name in ("LOOP_CARRY_SPEC", "BUFFER_STATE_SPEC", "ROUTED_BUFFER_STATE_SPEC",
                 "CHAINED_CARRY_SPEC"):
        ours, theirs = getattr(sharding, name), getattr(jax_sharding, name)
        shared = set(ours) & set(theirs)
        assert shared == set(theirs), name  # every JAX field is declared here
        assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}, name
    # the one field JAX's ChainedCarry lacks: the learners' latched gates
    assert set(sharding.CHAINED_CARRY_SPEC) - set(jax_sharding.CHAINED_CARRY_SPEC) == {"training"}
    assert sharding.CHAINED_CARRY_SPEC["training"] == "rep"


@pytest.fixture(scope="module")
def small_carry():
    torch.set_num_threads(1)
    env, agent, rb, config, init_fn, _ = make_state_sim_experiment(
        device="cpu", num_envs=4, batch_size=4, utd_ratio=2, buffer_capacity=64)
    return rb, init_fn(agent, 0)


def test_torch_sharding_unknown_carry_field_rejected(small_carry):
    from serl_tpu_torch.training.loop import LoopCarry

    _, carry = small_carry
    grown_type = collections.namedtuple("GrownLoopCarry", LoopCarry._fields + ("mystery_field",))
    grown = grown_type(*carry, torch.zeros((4,)))
    with pytest.raises(ValueError, match="mystery_field"):
        sharding.carry_layout(grown, _dp())
    assert sharding.carry_layout(carry, _dp())["rb_state"] == "buffer"


@pytest.mark.parametrize("what", ["envs", "streams"])
def test_torch_sharding_uneven_split_rejected(small_carry, what):
    rb, carry = small_carry
    if what == "envs":
        with pytest.raises(ValueError, match="divide"):
            sharding.carry_layout(carry, _dp(world=3))
        return
    ring = rb.init_state(streams=2)  # 2 streams over 4 ranks, 4 envs
    with pytest.raises(ValueError, match="buffer streams 2 must divide"):
        sharding.carry_layout(carry._replace(rb_state=ring), _dp(world=4))


def test_torch_sharding_minibatch_rows_and_draw_shares():
    """Rank r's rows of each minibatch, and the draws that follow them."""
    assert sharding.minibatch_rows(32, 4, _dp(1)).tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23, 28, 29, 30, 31]
    draws = [{"critic_next_eps": torch.arange(8.0)[:, None], "subsample_idx": torch.tensor([3, 1])}
             for _ in range(4)] + [{"actor_eps": torch.arange(32.0)[:, None],
                                    "actor_dropout": {"front": torch.arange(64)[:, None]}}]
    got = sharding.share_draws(draws, 32, 4, _dp(1))
    assert got[0]["critic_next_eps"][:, 0].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert got[0]["subsample_idx"].tolist() == [3, 1]
    assert got[4]["actor_eps"][:, 0].tolist() == sharding.minibatch_rows(32, 4, _dp(1)).tolist()
    # a mask of two cameras stacked along the batch: block by block
    want = sharding.minibatch_rows(32, 4, _dp(1)).tolist()
    assert got[4]["actor_dropout"]["front"][:, 0].tolist() == want + [32 + r for r in want]
    with pytest.raises(ValueError, match="divide"):
        sharding.minibatch_rows(12, 4, _dp(world=2))  # minibatches of 3 rows over 2 ranks


@pytest.mark.parametrize("device, backend, cards, match", [
    ("cpu", "nccl", 0, "gloo"),            # the CPU runs over gloo
    ("cuda", "nccl", 1, "--backend gloo"),  # NCCL a card a rank: 2 ranks, 1 card
    ("cuda", "gloo", 0, "CUDA card"),       # no card at all
])
def test_torch_sharding_backend_checks(monkeypatch, device, backend, cards, match):
    """No silent switch between backends or devices: dryrun_multichip
    raises, naming the way out."""
    from serl_tpu_torch.examples import dryrun_multichip as dm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises((ValueError, RuntimeError), match=match):
        dm.check_backend(device, backend, WORLD)


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("form", FORMS)
def test_torch_sharding_update_high_utd_matches_jax(runs, form):
    i = FORMS.index(form)
    want_state, want_info = runs["jax"][i]
    got = [rank[0][i] for rank in runs["ranks"]]
    # replicated bit for bit
    flat = [{k: np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(g["state"])[0]} for g in got]
    assert flat[0].keys() == flat[1].keys()
    for k in flat[0]:
        np.testing.assert_array_equal(flat[0][k], flat[1][k], err_msg=str(k))
    assert_states_close(got[0]["state"], want_state, atol=2e-6)
    for g in ("critic", "actor", "temperature"):
        for k, v in want_info[g].items():
            np.testing.assert_allclose(got[0]["info"][g][k], float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{form} {g} {k}")
    # one exchange; an all-reduce per group that steps: UTD critic steps,
    # then the actor's and the temperature's, and the BC term's row count
    want = {"all_to_all": 1, "all_reduce": UTD[form] + 2 + (form == "bc")}
    for rank in got:
        assert {k: v["calls"] for k, v in rank["collectives"].items()} == want


# ---------------------------------------------------------------- (c)


def test_torch_sharding_loop_two_ranks_match_one(runs):
    two = [rank[1][0] for rank in runs["ranks"]]
    one = runs["one"][0]
    first = one["gate_iter"]
    assert first == LOOP_SEGMENTS[0] and all(r["gate_iter"] == first for r in two)
    snaps = [torch_dp.merge_snapshots([runs["snap"] / f"state_r{r}_s{s}.pt" for r in range(WORLD)])
             for s in range(len(LOOP_SEGMENTS))]
    refs = [torch.load(runs["ref_snap"] / f"state_r0_s{s}.pt", weights_only=False)
            for s in range(len(LOOP_SEGMENTS))]
    # up to the first update: every draw the same, every env row and ring slot equal
    assert torch_dp.max_abs_diff(snaps[0]["env"], refs[0]["env"]) == 0.0
    assert torch_dp.max_abs_diff(snaps[0]["rings"]["rb_state"], refs[0]["rings"]["rb_state"]) == 0
    assert torch_dp.max_abs_diff(snaps[0]["agents"][0], refs[0]["agents"][0]) == 0.0
    # after four updating iterations
    assert all(s["agents_equal"] for s in snaps)
    for part in ("env", "agents"):
        got = snaps[1][part] if part == "env" else snaps[1][part][0]
        ref = refs[1][part] if part == "env" else refs[1][part][0]
        assert torch_dp.max_abs_diff(got, ref) <= LOOP_ATOL, part
    assert torch_dp.max_abs_diff(snaps[1]["rings"]["rb_state"],
                                 refs[1]["rings"]["rb_state"]) <= LOOP_ATOL
    # the metrics: episode counts exact, sums over the ranks within rounding
    for k, v in one["metrics"].items():
        for r in two:
            if k in ("env_steps", "buffer_size", "ep_count"):
                assert torch.equal(r["metrics"][k], v), k
            else:
                np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    # an insert issues no collective; per iteration one all-reduce of the
    # statistics, per update one exchange and UTD + 2 gradient all-reduces,
    # and one all_gather of the digests after each segment
    iters, updating = sum(LOOP_SEGMENTS), sum(LOOP_SEGMENTS) - first
    for r in two:
        assert r["inserts_without_collectives"][1] and r["inserts_without_collectives"][0] > 0
        assert {k: v["calls"] for k, v in r["collectives"].items()} == {
            "all_reduce": iters + updating * (LOOP["utd_ratio"] + 2),
            "all_to_all": updating, "all_gather": len(LOOP_SEGMENTS)}
        assert r["collectives"]["all_to_all"]["bytes"] > 0


# ---------------------------------------------------------------- (d)


def test_torch_sharding_chained_loop_gates_open_together(runs):
    two = [rank[1][1] for rank in runs["ranks"]]
    one = runs["one"][1]

    def gates(result):
        m = result["metrics"]
        return tuple(int((m[f"{t}/critic_loss"][:, 0] != 0).nonzero()[0]) for t in ("fw", "bw"))

    assert gates(two[0]) == gates(two[1]) == gates(one)
    n = 2 * WORLD
    for r in two:
        assert r["routed_rows"] == r["iters"] * n == one["routed_rows"]
        assert r["digest"] == two[0]["digest"]
    for k in ("ep_count", "fw_rows", "bw_rows", "env_steps"):
        assert torch.equal(two[0]["metrics"][k], one["metrics"][k]), k
