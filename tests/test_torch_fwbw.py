"""The chained fwbw program against serl_tpu, on the CPU.

- `make_chained_loop` over `ChainedBinEnv` (4 chained envs, the time limit
  cut to 3 steps so that episodes end and tasks flip or retry inside the
  run; small agents: 32-wide MLPs, 4 critics), the relocation expert
  rescuing at p 0.5, half-demo batches from routed demo rings: every reset
  and chained reset takes JAX's draws (its key chain), and each iteration is
  replayed through JAX's vmapped `step_auto_reset` from the port's own
  state: the rows each ring received (only the streams of its task, at
  their own cursors: observations to 1e-5, the tcp pose's Euler angles
  modulo 2 pi to 1e-3 (the roll's +-pi flip), rewards to 1e-5, dones, masks
  and episode ids exactly), the next tasks,
  clocks and ids exactly, the per-task sums (episodes, returns, success,
  ground-truth success, switches) against the replay's, and each learner's
  update: the batch it drew and its state before, through JAX's
  update_high_utd with the same draws, its critic loss to 1e-5 relative
  (tests/test_torch_learner.py's rule), its actor loss to 1e-4 relative and
  its new params and targets to 1e-4 (a first Adam step from zero moments
  maps g to g / |g|: ill-conditioned, as tests/test_torch_learner.py says).
- `collect_chained_demos` with JAX's draws against JAX's own run: both
  routed rings' cursors, sizes and episode ids exactly, observations and
  rewards to 1e-4 (angles modulo 2 pi to 1e-3), the expert's actions to
  1e-3, the statistics.
- `evaluate_chained_env`'s bookkeeping (the forward attempt, the switch,
  the backward episode, frozen chains, the backward-only diagnostic) on a
  scripted chained env and scripted agents written in both frameworks:
  every metric equal.
- The example's argv path on the CPU, states and --pixels (evaluations
  stubbed), the classifier trainer on given frames, the learning check's
  fwbw and PCB recipes, and the CUDA default.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu.data.routed_buffer import RoutedReplayBuffer as JaxRouted
from serl_tpu.envs import chained_bin as jchained
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.training import fwbw as jfwbw
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.envs import chained_bin, tasks
from serl_tpu_torch.envs.panda_pick import EnvState
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.examples import fused_fwbw_bin_relocation as example
from serl_tpu_torch.examples import learning_check
from serl_tpu_torch.training import fwbw
from serl_tpu_torch.utils.jax_params import train_state_to_jax_layout
from tests.test_torch_bin_env import jax_chain_draws
from tests.test_torch_learner import (
    _kwargs,
    assert_trees_close,
    jax_high_utd_draws,
    jax_state_np,
    jax_with_state,
)
from tests.torch_pose_jax import angle_error, jax_reset_draws, to_jax

EPT, LIMIT, OBS, ACT, E = 2, 3, tasks.STATE_OBS_DIM, 7, 4
N = 2 * EPT
ANGLES = slice(7, 10)  # the tcp pose's Euler angles in the flat (sorted-key) observation


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cut(env):
    """The env with its time limit cut to LIMIT steps (both tasks)."""
    for e in (env.fw, env.bw):
        e.config = e.config._replace(time_limit_steps=LIMIT)
    return env


def _example_tr():
    return {"observations": np.zeros((OBS,), np.float32), "actions": np.zeros((ACT,), np.float32),
            "next_observations": np.zeros((OBS,), np.float32), "rewards": np.zeros((), np.float32),
            "masks": np.zeros((), np.float32), "dones": np.zeros((), np.float32)}


def _rings(capacity):
    ex = _example_tr()
    return (JaxRouted({k: jnp.asarray(v) for k, v in ex.items()}, capacity=capacity),
            fwbw_ring(capacity))


def fwbw_ring(capacity):
    from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer

    return RoutedReplayBuffer({k: torch.from_numpy(v) for k, v in _example_tr().items()},
                              capacity=capacity, device="cpu")


class _KeyChain:
    """JAX's per-env keys, mirrored: each reset's and chained reset's draws
    from them, and the key each env carries on (its reset's k_next)."""

    def __init__(self, env, monkeypatch):
        self.rng = None
        inner = env.step_auto_reset

        def reset(n, generator=None, task=None, draws=None, task_draw=None):
            keys = self.pending_keys
            split = jax.vmap(jax.random.split)(keys)
            k_task, k_env = split[:, 0], split[:, 1]
            if task is None:
                task_draw = torch.from_numpy(np.array(jax.vmap(
                    lambda k: jax.random.randint(k, (), 0, 2))(k_task)))
            self.rng = jax.vmap(lambda k: jax.random.split(k, 4)[3])(k_env)
            return chained_bin.ChainedBinEnv.reset(
                env, n, draws=jax_reset_draws(k_env, env.fw.config, jitter=True), task=task,
                task_draw=task_draw)

        def step(state, action, generator=None, draws=None, final_obs=True):
            self.before_rng = self.rng
            chain = jax.vmap(jax.random.fold_in)(self.rng, jnp.asarray(state.env.ep_id.numpy()))
            out = inner(state, action, draws=jax_chain_draws(chain), final_obs=final_obs)
            k_next = jax.vmap(lambda k: jax.random.split(k, 4)[3])(chain)
            done = jnp.asarray(out[3].numpy() > 0.5)
            self.rng = jnp.where(done[:, None], k_next, self.rng)
            return out

        monkeypatch.setattr(env, "reset", reset)
        monkeypatch.setattr(env, "step_auto_reset", step)


def _small_agent(seed):
    return SACAgent.create_states(torch.zeros(1, OBS), torch.zeros(1, ACT),
                                  generator=torch.Generator().manual_seed(seed),
                                  **_kwargs("tanh"), device="cpu")


def _assert_obs(got, want, atol=1e-5, angle_atol=1e-3):
    """Flat observations: to `atol`; the tcp pose's Euler angles modulo 2 pi
    to `angle_atol`: the bin task's roll sits at the +-pi flip, where float32
    mat_to_quat is ill-conditioned (up to ~2e-4 apart between the
    frameworks on one state; tests/torch_pose_jax.py)."""
    got, want = np.atleast_2d(np.asarray(got)), np.atleast_2d(np.asarray(want))
    rest = np.r_[0:7, 10:13]
    np.testing.assert_allclose(got[..., rest], want[..., rest], atol=atol, rtol=0)
    assert angle_error(got[..., ANGLES], want[..., ANGLES]).max() <= angle_atol


def test_torch_chained_loop_matches_jax_step_by_step(monkeypatch):
    env = _cut(chained_bin.ChainedBinEnv(fresh_reset_prob=0.3, device="cpu"))
    jenv = _cut(jchained.ChainedBinEnv(fresh_reset_prob=0.3))
    chain = _KeyChain(env, monkeypatch)
    config = fwbw.FwBwConfig(envs_per_task=EPT, batch_size=8, utd_ratio=2, training_starts=8,
                             random_steps=8, buffer_capacity=N * 10, demo_fraction=0.5,
                             intervention_prob=0.5, intervention_mode="rescue")
    rb = fwbw_ring(config.buffer_capacity)
    demo_rb = fwbw_ring(2 * 6)
    # demo rings: rewards -1 mark their rows in the learners' batches
    fw_demo, bw_demo = demo_rb.init_state(2), demo_rb.init_state(2)
    for ring in (fw_demo, bw_demo):
        for i in range(6):
            tr = {k: torch.full((2,) + v.shape, 0.1 * i) for k, v in _example_tr().items()}
            tr["rewards"] = torch.full((2,), -1.0)
            demo_rb.insert(ring, tr, torch.tensor([0, 1], dtype=torch.int32))
    agents = {"fw": _small_agent(1), "bw": _small_agent(2)}
    records, keys = [], iter(jax.random.split(jax.random.PRNGKey(11), 64))
    for name, agent in agents.items():
        inner = agent.update_high_utd

        def spy(batch, *, utd_ratio, draws=None, generator=None, name=name, agent=agent,
                inner=inner):
            key = next(keys)
            rec = {"name": name, "key": key, "before": train_state_to_jax_layout(agent),
                   "batch": {k: v.numpy().copy() for k, v in batch.items()}}
            out = inner(batch, utd_ratio=utd_ratio, draws=jax_high_utd_draws(
                key, batch["rewards"].shape[0], utd_ratio, ensemble=E, action_dim=ACT))
            rec["after"], rec["info"] = train_state_to_jax_layout(agent), out[1]
            records.append(rec)
            return out

        monkeypatch.setattr(agent, "update_high_utd", spy)

    init_fn, run_chunk = fwbw.make_chained_loop(env, rb, config)
    chain.pending_keys = jax.random.split(jax.random.PRNGKey(3), N)
    carry = init_fn(agents["fw"], agents["bw"], 0, fw_demo=fw_demo, bw_demo=bw_demo,
                    demo_rb=demo_rb)
    jauto = jax.jit(jax.vmap(jenv.step_auto_reset))
    jobs = jax.jit(jax.vmap(lambda s: jpick.flatten_obs(jenv.fw._obs(s))))
    counts = {0: np.zeros(N, int), 1: np.zeros(N, int)}
    want_sums = {k: np.zeros(2) for k in ("ep_count", "ret_sum", "succ_sum", "succ_gt_sum")}
    ep_return, switches, flips = np.zeros(N), 0, 0
    for _ in range(9):
        before = carry.env_states
        task = before.task.numpy()
        carry, metrics = run_chunk(carry, 1)
        js = jchained.ChainedState(env=to_jax(before.env, chain.before_rng),
                                   task=jnp.asarray(task))
        rings = {0: carry.fw_rb, 1: carry.bw_rb}
        # the transition of env j sits in its task's ring, at its stream's slot
        actions = np.stack([rings[task[j]].data["actions"][counts[task[j]][j] % 10, j].numpy()
                            for j in range(N)])
        new, _, jr, jd, ji = jauto(js, jnp.asarray(actions))
        for t in (0, 1):
            ring = rings[t]
            for j in range(N):
                slot = counts[t][j] % 10
                if task[j] != t:
                    assert int(ring.size[j]) == min(counts[t][j], 10)  # untouched
                    continue
                _assert_obs(ring.data["observations"][slot, j], jobs(js.env)[j])
                _assert_obs(ring.data["next_observations"][slot, j],
                            jpick.flatten_obs(jax.tree.map(lambda x: x[j], ji["final_obs"])))
                np.testing.assert_allclose(float(ring.data["rewards"][slot, j]), float(jr[j]),
                                           atol=1e-5)
                assert float(ring.data["dones"][slot, j]) == float(jd[j])
                assert float(ring.data["masks"][slot, j]) == 1.0 - float(jd[j])
                assert int(ring.ep_id[slot, j]) == int(before.env.ep_id[j]) * N + j
                counts[t][j] += 1
        np.testing.assert_array_equal(carry.env_states.task.numpy(), np.asarray(new.task))
        np.testing.assert_array_equal(carry.env_states.env.t.numpy(), np.asarray(new.env.t))
        np.testing.assert_array_equal(carry.env_states.env.ep_id.numpy(), np.asarray(new.env.ep_id))
        # the per-task sums, from the replay
        done = np.asarray(jd) > 0.5
        ep_return += np.asarray(jr)
        for t in (0, 1):
            sel = done & (task == t)
            want_sums["ep_count"][t] += sel.sum()
            want_sums["ret_sum"][t] += ep_return[sel].sum()
            want_sums["succ_sum"][t] += np.asarray(ji["success"])[sel].sum()
            want_sums["succ_gt_sum"][t] += np.asarray(ji["success_gt"])[sel].sum()
        ep_return[done] = 0.0
        switches += int(np.asarray(ji["switched"]).sum())
        flips += int((np.asarray(new.task) != task).sum())
        for k, v in want_sums.items():
            np.testing.assert_allclose(metrics[k][-1].numpy(), v, atol=1e-4, err_msg=k)
        assert float(metrics["switch_sum"][-1]) == switches
    assert want_sums["ep_count"].sum() >= N and flips >= 1  # episodes ended, tasks changed
    assert counts[0].sum() > 0 and counts[1].sum() > 0
    # both learners updated once their rings held 8 rows, on half-demo batches
    assert {r["name"] for r in records} == {"fw", "bw"}
    assert carry.training == (True, True)
    jagent = JaxSACAgent.create_states(jax.random.PRNGKey(0), jnp.zeros((1, OBS)),
                                       jnp.zeros((1, ACT)), **_kwargs(jnp.tanh))
    for rec in (next(r for r in records if r["name"] == n) for n in ("fw", "bw")):
        np.testing.assert_array_equal(rec["batch"]["rewards"][1::2], -1.0)
        batch = {k: jnp.asarray(v) for k, v in rec["batch"].items()}
        jnew, jinfo = jax_with_state(jagent, rec["before"], rec["key"]).update_high_utd(
            batch, utd_ratio=2)
        want = jax_state_np(jnew)
        for part in ("params", "target_params"):
            assert_trees_close(rec["after"][part], want[part], 1e-4, what=part)
        np.testing.assert_allclose(float(rec["info"]["critic"]["critic_loss"]),
                                   float(jinfo["critic"]["critic_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(rec["info"]["actor"]["actor_loss"]),
                                   float(jinfo["actor"]["actor_loss"]), rtol=1e-4, atol=1e-6)


def test_torch_collect_chained_demos_matches_jax(monkeypatch):
    env = _cut(chained_bin.ChainedBinEnv(fresh_reset_prob=0.5, device="cpu"))
    jenv = _cut(jchained.ChainedBinEnv(fresh_reset_prob=0.5))
    chain = _KeyChain(env, monkeypatch)
    streams, steps = 3, 5
    jrb, trb = _rings(streams * steps)
    rng = jax.random.PRNGKey(5)
    jfw, jbw, jstats = jfwbw.collect_chained_demos(jenv, jrb, streams, steps, rng)
    chain.pending_keys = jax.random.split(rng, streams)
    tfw, tbw, tstats = fwbw.collect_chained_demos(env, trb, streams, steps, 0)
    assert tstats == {k: (float(v) if k in ("episodes", "success_rate") else int(v))
                      for k, v in jstats.items()}
    assert tstats["fw_rows"] > 0 and tstats["bw_rows"] > 0
    for got, want in ((tfw, jfw), (tbw, jbw)):
        for field in ("insert_slot", "size", "ep_id"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        for k in ("observations", "next_observations"):
            _assert_obs(got.data[k].numpy().reshape(-1, OBS),
                        np.asarray(want.data[k]).reshape(-1, OBS), atol=1e-4)
        # the expert's gain 1 / (2 x 0.05) turns tcp differences of 1e-5 into 1e-4
        np.testing.assert_allclose(got.data["actions"].numpy(), np.asarray(want.data["actions"]),
                                   atol=1e-3)
        np.testing.assert_allclose(got.data["rewards"].numpy(), np.asarray(want.data["rewards"]),
                                   atol=1e-4)
        for k in ("masks", "dones"):
            np.testing.assert_array_equal(got.data[k].numpy(), np.asarray(want.data[k]))


# ---------------------------------------------------------------- evaluation


class _JaxFakeEnv(struct.PyTreeNode):
    """A scripted chained env for JAX's evaluate_chained_env: a chain k
    (drawn from its key) succeeds when its agent's action says so at step
    >= 2 of an episode; episodes end on success or at 3 steps."""

    fresh_reset_prob: float = struct.field(pytree_node=False, default=0.0)
    classifier_fns: object = struct.field(pytree_node=False, default=None)
    time_limit_steps: int = struct.field(pytree_node=False, default=3)

    @staticmethod
    def _obs(s):
        x = jnp.stack([s.env.t, s.env.ep_id, s.task, s.env.k]).astype(jnp.float32)
        return {"state": {"x": x}}

    def reset(self, key, task=None):
        s = jchained.ChainedState(env=_JState(t=jnp.int32(0), ep_id=jnp.int32(0),
                                              k=jax.random.randint(key, (), 0, 1000)),
                                  task=jnp.int32(task))
        return s, self._obs(s)

    def step_auto_reset(self, s, action):
        t = s.env.t + 1
        succ = (action[0] > 0.5) & (t >= 2)
        done = succ | (t >= self.time_limit_steps)
        nxt = jnp.where(succ, 1 - s.task, s.task)
        new = jchained.ChainedState(
            env=_JState(t=jnp.where(done, 0, t), ep_id=s.env.ep_id + done.astype(jnp.int32),
                        k=s.env.k), task=jnp.where(done, nxt, s.task))
        info = {"switched": done & (nxt != s.task), "success_gt": succ.astype(jnp.float32)}
        return new, self._obs(new), succ.astype(jnp.float32), done.astype(jnp.float32), info


class _JState(struct.PyTreeNode):
    t: jnp.ndarray
    ep_id: jnp.ndarray
    k: jnp.ndarray


class _JaxFakeAgent(struct.PyTreeNode):
    mod: int = struct.field(pytree_node=False)

    def sample_actions(self, obs, argmax=False):
        k = obs[:, 3].astype(jnp.int32)
        go = (k % self.mod != 0).astype(jnp.float32)
        return jnp.concatenate([go[:, None], jnp.zeros((obs.shape[0], 6))], -1)


class _TorchFakeEnv:
    """The same scripted env, batched, for the port (k of each reset given)."""

    fresh_reset_prob, classifier_fns, time_limit_steps = 0.0, None, 3
    device = torch.device("cpu")

    def __init__(self, ks):
        self.ks = list(ks)

    @staticmethod
    def _obs(s):
        x = torch.stack([s.env.t, s.env.ep_id, s.task, s.env.z_init.to(torch.int32)], -1)
        return {"state": {"x": x.to(torch.float32)}}

    def reset(self, n, generator=None, task=None):
        k = self.ks.pop(0)
        zeros = torch.zeros(n, dtype=torch.int32)
        s = chained_bin.ChainedState(
            EnvState(engine.init_state(torch.zeros(n, 2)), zeros, k.to(torch.float32), zeros),
            torch.full((n,), int(task), dtype=torch.int32))
        return s, self._obs(s)

    def step_auto_reset(self, s, action, generator=None, final_obs=True):
        t = s.env.t + 1
        succ = (action[:, 0] > 0.5) & (t >= 2)
        done = succ | (t >= self.time_limit_steps)
        nxt = torch.where(succ, 1 - s.task, s.task)
        es = s.env._replace(t=torch.where(done, 0, t).to(torch.int32),
                            ep_id=s.env.ep_id + done.to(torch.int32))
        new = chained_bin.ChainedState(es, torch.where(done, nxt, s.task).to(torch.int32))
        info = {"switched": done & (nxt != s.task), "success_gt": succ.to(torch.float32)}
        return new, self._obs(new), succ.to(torch.float32), done.to(torch.float32), info


class _TorchFakeAgent:
    def __init__(self, mod):
        self.mod = mod

    def sample_actions(self, obs, argmax=False):
        go = (obs[:, 3].to(torch.int64) % self.mod != 0).to(torch.float32)
        return torch.cat([go[:, None], torch.zeros(obs.shape[0], 6)], -1)


def test_torch_evaluate_chained_env_matches_jax():
    n = 24
    rng = jax.random.PRNGKey(4)
    want = jfwbw.evaluate_chained_env(_JaxFakeEnv(), _JaxFakeAgent(3), _JaxFakeAgent(2), rng,
                                      num_episodes=n)
    keys = jax.random.split(rng, n)
    draw = lambda ks: torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, 1000))(ks)))
    ks = [draw(keys), draw(jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys))]
    got = fwbw.evaluate_chained_env(_TorchFakeEnv(ks), _TorchFakeAgent(3), _TorchFakeAgent(2), 0,
                                    num_episodes=n)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert 0 < got["eval/round_trip_success"] < got["eval/fw_success"] < 1
    with pytest.raises(ValueError):
        fwbw.evaluate_chained_env(chained_bin.ChainedBinEnv(device="cpu"), None, None)


# ---------------------------------------------------------------- the example

TINY = ["--device", "cpu", "--envs_per_task", "1", "--batch_size", "4", "--utd_ratio", "2",
        "--training_starts", "4", "--random_steps", "2", "--demo_streams", "2",
        "--demo_steps", "4", "--total_steps", "8", "--eval_period", "4",
        "--intervention_mode", "rescue", "--intervention_prob", "0.5"]


@pytest.mark.parametrize("pixels", [False, True])
def test_torch_fwbw_example_runs_on_cpu(pixels, tmp_path, monkeypatch):
    evals = []

    def fake_eval(env, fw_agent, bw_agent, rng=None, num_episodes=32, pixel_keys=()):
        evals.append((num_episodes, tuple(pixel_keys), env.fresh_reset_prob))
        rt = 0.9 if len(evals) <= 2 else 0.1
        return {"eval/fw_success": 1.0, "eval/bw_success": 0.5, "eval/bw_success_given_fw": rt,
                "eval/round_trip_success": rt}

    monkeypatch.setattr(example, "evaluate_chained_env", fake_eval)
    log = tmp_path / "log.txt"
    argv = TINY + ["--log", str(log), "--log_dir", str(tmp_path / "logs"), "--solve_threshold",
                   "0.8"] + (["--pixels", "--image_size", "32"] if pixels else [])
    carry = example.main(argv)
    text = log.read_text()
    assert "chained demos:" in text and "SOLVED" in text and "FINAL" in text
    assert carry.env_steps == 8 and any(carry.training)
    keys = example.IMAGE_KEYS if pixels else ()
    assert evals[0] == (32, keys, 0.0) and evals[-1][0] == example.FINAL_EPISODES
    rows = [json.loads(line) for f in os.listdir(tmp_path / "logs")
            for line in open(tmp_path / "logs" / f)]
    ev = [r for r in rows if "eval/success_rate" in r]
    assert [r["eval/success_rate"] for r in ev] == [0.9, 0.9]
    assert all("eval/fw_success" in r and "eval/bw_success_given_fw" in r for r in ev)
    ring = carry.fw_rb.data["observations"]
    assert (ring["front"].dtype == torch.uint8) if pixels else ring.shape[-1] == OBS


def test_torch_fwbw_classifiers_on_given_frames():
    args = example.parser().parse_args(["--device", "cpu", "--image_size", "32"])
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (40, 1, 32, 32, 3), generator=g, dtype=torch.uint8)
    cubes = torch.cat([torch.tensor(tasks.FW_BIN).repeat(20, 1), torch.tensor(tasks.BW_BIN)
                       .repeat(20, 1)]) + 0.03 * torch.rand((40, 2), generator=g)
    cubes = torch.cat([cubes, torch.full((40, 1), 0.02)], -1)
    labels = (tasks.bin_success(cubes, torch.tensor(tasks.FW_BIN)),
              tasks.bin_success(cubes, torch.tensor(tasks.BW_BIN)))
    lines = []

    class Out:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass

    (fw_fn, bw_fn), info = example.train_fwbw_classifiers(args, Out(), "cpu",
                                                          data=(frames, cubes, *labels), epochs=3)
    assert info["fw"]["positives"] == int(labels[0].sum()) > 0
    assert set(info["fw"]["fp_fn"]) == set(example.FP_THRESHOLDS)
    assert any("FP/FN per threshold" in s for s in lines)
    assert fw_fn({"front": frames[:5]}).shape == (5,)
    # the classifiers drive a chained env's switch
    env = chained_bin.ChainedBinEnv(render_size=32, classifier_fns=(fw_fn, bw_fn),
                                    classifier_threshold=0.5, device="cpu")
    assert env.classifier_fns is not None


def test_torch_fwbw_example_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA card")
    with pytest.raises(RuntimeError):
        example.build(example.parser().parse_args([]))


def test_torch_learning_check_runs_the_fwbw_and_pcb_recipes(tmp_path, monkeypatch):
    started = []

    class Proc:
        def __init__(self, cmd, **kw):
            started.append(cmd)

        def wait(self):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(learning_check, "card_line", lambda: "card, 700 W")
    monkeypatch.setattr(learning_check.subprocess, "Popen", Proc)
    for name in ("fused_fwbw_bin_relocation", "fused_pcb_insert"):
        out = tmp_path / name
        os.makedirs(out)
        for s in (0, 1, 2):
            (out / f"seed{s}.log").write_text("")
        assert learning_check.main(["--example", name, "--out", str(out),
                                    "--total_env_steps", "1000"]) == 0
    fwbw_cmd, pcb_cmd = started[0], started[3]
    assert fwbw_cmd[2] == "serl_tpu_torch.examples.fused_fwbw_bin_relocation"
    for flag, value in (("--bc_weight", "0.3"), ("--intervention_mode", "rescue"),
                        ("--intervention_min_prob", "0.008"), ("--demo_steps", "600"),
                        ("--fresh_reset_prob", "0.1"), ("--total_steps", "1000")):
        assert fwbw_cmd[fwbw_cmd.index(flag) + 1] == value
    for flag, value in (("--bc_weight", "0.1"), ("--intervention_min_prob", "0.05")):
        assert pcb_cmd[pcb_cmd.index(flag) + 1] == value
    # both examples take the learning check's flags
    example.parser().parse_args(fwbw_cmd[3:])
    from serl_tpu_torch.examples import fused_pcb_insert

    fused_pcb_insert.parser().parse_args(pcb_cmd[3:])
