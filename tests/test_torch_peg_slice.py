"""The peg slice end to end against serl_tpu, on the CPU.

- The peg state loop: `make_fused_loop` over `PandaPoseTaskEnv` (PEG, its
  time limit cut to 4 steps so that episodes end inside the run), the pose
  expert intervening on whole episodes, RLPD batches (demo_fraction 0.5)
  from the peg example's own demo ring, for 7 iterations. Every reset takes
  JAX's draws (its key chain: fold_in(rng, ep_id) at each step, the fresh
  state's key after a reset), and every iteration is replayed through JAX's
  vmapped `step_auto_reset` from the port's own state before it: the stored
  observations, rewards, dones, masks, next observations and episode ids,
  and the next states (the stepped and the freshly reset and settled ones)
  under tests/torch_k1.py's per-env rule with the port's float64 run as the
  measure of rounding; an intervening env stores the pose expert's action
  (JAX's at the same state, translation to 1e-5), and every learner batch
  is half demo rows, at the odd positions.
- One SAC update with the Q-filtered BC term (bc_regularization 0.1) from a
  mid-training learner state against JAX's: the actor loss with its bc_loss
  and bc_active_frac, each group's gradient, and the whole update (params,
  targets, Adam moments), with JAX's draws (tests/test_torch_learner.py's
  tolerances).
- The PCB example: the checkpoint flags reach run_fused, --bc_weight the
  agent, --lr_decay its cosine schedules; the learning check starts the peg
  example with its recipe untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.agents.sac import SACAgent as JaxSACAgent
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import scripted_expert as jexpert
from serl_tpu.envs import tasks as jtasks
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.envs.physics import engine
from serl_tpu_torch.examples import fused_pcb_insert, fused_peg_insert, learning_check
from serl_tpu_torch.training.launcher import make_sac_agent, make_state_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop
from serl_tpu_torch.utils.jax_params import group_tree, load_train_state, train_state_to_jax_layout
from tests.test_torch_learner import (
    ACT,
    OBS,
    _batch,
    _jb,
    _kwargs,
    _np,
    _tb,
    assert_states_close,
    assert_trees_close,
    jax_loss_draws,
    jax_state_np,
    jax_update_draws,
    jax_with_state,
)
from tests.torch_pose_jax import angle_error, assert_physics_close, jax_reset_draws, to_jax

N, ITERS, LIMIT, ATOL = 4, 7, 4, 1e-3
CFG = tasks.PEG_INSERT_CONFIG._replace(time_limit_steps=LIMIT)
JCFG = jtasks.PEG_INSERT_CONFIG._replace(time_limit_steps=LIMIT)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f64(p):
    return type(p)(*(x.double() for x in p))


def _settled(p):
    for _ in range(tasks.SETTLE_STEPS):
        p = engine.control_step_plain(p)
    return p


def test_torch_peg_state_loop_matches_jax_step_by_step(monkeypatch):
    env = tasks.PandaPoseTaskEnv(CFG, device="cpu")
    expert = fused_peg_insert.pose_expert(CFG)
    demo_state, _, _ = fused_peg_insert.expert_demos(env, expert, seed=0, num_demos=2)
    demo_state.data["rewards"].fill_(-1.0)  # marks the demo rows (online rewards are >= 0)
    config = LoopConfig(num_envs=N, batch_size=4, utd_ratio=2, training_starts=8, random_steps=8,
                        buffer_capacity=64, demo_fraction=0.5, intervention_prob=0.5,
                        intervention_mode="episode")
    rb = make_state_replay_buffer(64, obs_dim=tasks.STATE_OBS_DIM, action_dim=7, device="cpu")
    agent = make_sac_agent(0, obs_dim=tasks.STATE_OBS_DIM, action_dim=7, discount=0.97,
                           device="cpu")
    init_fn, run_chunk = make_fused_loop(env, rb, config, expert_fn=expert)
    batches, inputs, pending = [], [], []
    update = agent.update_high_utd
    agent.update_high_utd = lambda batch, **kw: batches.append(batch["rewards"].clone()) or \
        update(batch, **kw)
    monkeypatch.setattr(env, "sample_reset_draws", lambda n, g=None: pending.pop())
    control_step = engine.control_step
    monkeypatch.setattr(engine, "control_step",
                        lambda p, obstacles=None: inputs.append(p) or control_step(p))

    jenv = jtasks.PandaPoseTaskEnv(JCFG)
    jauto = jax.jit(jax.vmap(jenv.step_auto_reset))
    jobs = jax.jit(jax.vmap(lambda s: jpick.flatten_obs(jenv._obs(s))))
    jexp = jax.jit(jax.vmap(lambda s: jexpert.pose_expert_action(
        s, jnp.asarray(JCFG.target_pose), jnp.asarray(JCFG.action_scale))))
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    pending.append(jax_reset_draws(keys, CFG))
    jrng = jax.vmap(lambda k: jax.random.split(k, 4)[3])(keys)  # _reset_state's k_next
    carry = init_fn(agent, 0, demo_state=demo_state)
    resets, intervened = 0, 0
    for t in range(ITERS):
        before = carry.env_states
        pending.append(jax_reset_draws(
            jax.vmap(jax.random.fold_in)(jrng, jnp.asarray(before.ep_id.numpy())), CFG))
        inputs.clear()
        owned = carry.intervening.clone()
        carry, metrics = run_chunk(carry, 1)
        assert len(inputs) == 1 + tasks.SETTLE_STEPS  # the step, then every env's fresh reset
        slot = carry.rb_state.data
        stored = {k: v[t].numpy() for k, v in slot.items()}
        js = to_jax(before, jrng)
        obs = stored["observations"]
        np.testing.assert_allclose(obs[:, np.r_[0:7, 10:13]],
                                   np.asarray(jobs(js))[:, np.r_[0:7, 10:13]], atol=1e-5, rtol=0)
        if owned.any():  # the expert's action is the one stored
            intervened += 1
            want = expert(before).numpy()
            np.testing.assert_array_equal(stored["actions"][owned.numpy()], want[owned.numpy()])
            np.testing.assert_allclose(want[:, :3], np.asarray(jexp(js))[:, :3], atol=1e-5,
                                       rtol=0)
        new, jo, jr, jd, ji = jauto(js, jnp.asarray(stored["actions"]))
        np.testing.assert_allclose(stored["rewards"], np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(stored["dones"], np.asarray(jd))
        np.testing.assert_array_equal(stored["masks"], 1.0 - np.asarray(jd))
        final = np.asarray(jpick.flatten_obs(ji["final_obs"]))
        np.testing.assert_allclose(stored["next_observations"][:, np.r_[0:7, 10:13]],
                                   final[:, np.r_[0:7, 10:13]], atol=ATOL, rtol=0)
        assert angle_error(stored["next_observations"][:, 7:10], final[:, 7:10]).max() <= ATOL
        np.testing.assert_array_equal(carry.rb_state.ep_id[t].numpy(),
                                      before.ep_id.numpy() * N + np.arange(N))
        # the next states: stepped where running, reset and settled where ended
        done = np.asarray(jd) > 0.5
        exact = _f64(inputs[0])
        exact = engine.PhysicsState(*(
            torch.where(torch.from_numpy(done).view((-1,) + (1,) * (a.dim() - 1)), b, a)
            for a, b in zip(engine.control_step_plain(exact), _settled(_f64(inputs[1])))))
        assert_physics_close(carry.env_states.physics, new.physics, exact)
        np.testing.assert_array_equal(carry.env_states.t.numpy(), np.asarray(new.t))
        np.testing.assert_array_equal(carry.env_states.ep_id.numpy(), np.asarray(new.ep_id))
        resets += int(done.any())
        jrng = new.rng
    assert resets >= 1 and intervened >= 1
    assert len(batches) == ITERS - 1  # the threshold of 8 rows is reached at the second insert
    assert (metrics["critic_loss"] != 0).all()
    for rewards in batches:  # half demo rows, interleaved
        np.testing.assert_array_equal((rewards == -1).numpy(), np.arange(8) % 2 == 1)


def _bc_agents():
    kw = _kwargs(jnp.tanh)
    jagent = JaxSACAgent.create_states(jax.random.PRNGKey(0), jnp.zeros((1, OBS)),
                                       jnp.zeros((1, ACT)), bc_regularization=0.1, **kw)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
                          _np(jagent.state.params))
    target = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                          {"critic": params["critic"]})
    jagent = jagent.replace(state=jagent.state.replace(
        params=jax.tree.map(jnp.asarray, params), target_params=jax.tree.map(jnp.asarray, target)))
    mid = jagent
    for i in range(3):
        mid, _ = mid.update_high_utd(_jb(_batch(32, 20 + i)), utd_ratio=4)
    tagent = SACAgent.create_states(torch.zeros(1, OBS), torch.zeros(1, ACT),
                                    generator=torch.Generator().manual_seed(1),
                                    **_kwargs("tanh"), bc_regularization=0.1, device="cpu")
    assert tagent.config.bc_regularization == 0.1
    return jagent, jax_state_np(mid), tagent


def test_torch_sac_update_with_bc_regularization_matches_jax():
    jagent, mid, tagent = _bc_agents()
    load_train_state(tagent, mid)
    batch = _batch(16, 3)
    batch["actions"][:3] = [1.0, -1.0, 0.5]  # clipped to +-0.999 for the log-likelihood
    jstate = jax_with_state(jagent, mid, jax.random.PRNGKey(0))
    params, key = jstate.state.params, jax.random.PRNGKey(9)
    (jloss, jinfo), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jstate.policy_loss_fn(_jb(batch), {**params, "actor": p}, key),
        has_aux=True))(params["actor"])
    loss, info = tagent.policy_loss_fn(_tb(batch), jax_loss_draws(key, "actor", 16))
    assert set(info) == set(jinfo) >= {"bc_loss", "bc_active_frac"}
    assert 0.0 < float(jinfo["bc_active_frac"]) < 1.0  # the filter keeps some rows, not all
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in jinfo.items():
        np.testing.assert_allclose(float(info[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    grads = torch.autograd.grad(loss, tagent.state.params["actor"])
    assert_trees_close(group_tree(tagent, "actor", grads), _np(jgrad), atol=2e-5, rtol=1e-4)
    # a whole update from the mid-training state
    key = jax.random.PRNGKey(7)
    jnew, jinfo = jax_with_state(jagent, mid, key).update(_jb(batch))
    draws, _ = jax_update_draws(key, 16, {"actor", "critic", "temperature"})
    _, info = tagent.update(_tb(batch), draws=draws)
    assert_states_close(train_state_to_jax_layout(tagent), jax_state_np(jnew), atol=1e-6)
    for k in ("actor_loss", "bc_loss", "bc_active_frac"):
        np.testing.assert_allclose(float(info["actor"][k]), float(jinfo["actor"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_torch_pcb_example_passes_its_flags(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(fused_pcb_insert, "run_fused", lambda *a, **kw: calls.append((a, kw)))
    fused_pcb_insert.main(["--device", "cpu", "--num_demos", "0", "--checkpoint_dir",
                           str(tmp_path), "--resume", "--bc_weight", "0.1", "--lr_decay",
                           "--total_steps", "3200", "--debug"])
    (args, kw), = calls
    env, agent, rb, config = args[:4]
    assert isinstance(env, tasks.PandaPoseTaskEnv) and env.config == tasks.PCB_INSERT_CONFIG
    assert (kw["checkpoint_dir"], kw["resume"], kw["success_stop"]) == (str(tmp_path), True, 0.9)
    assert (kw["chunk_iters"], kw["eval_period_chunks"], kw["total_env_steps"]) == (50, 5, 3200)
    assert agent.config.bc_regularization == 0.1 and agent.config.discount == 0.97
    assert agent.state.txs["actor"].cosine_decay_steps == 200
    assert agent.state.txs["critic"].cosine_decay_steps == 800
    assert config.demo_fraction == 0.0 and config.buffer_capacity == 100_000
    assert (config.intervention_prob, config.intervention_mode) == (0.5, "episode")


def test_torch_learning_check_starts_the_peg_example(tmp_path, monkeypatch):
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
    assert learning_check.main(["--out", str(tmp_path), "--example", "fused_peg_insert",
                                "--pixels", "--seeds", "0", "2", "--total_env_steps", "96000",
                                "--success_stop", "0.9"]) == 0
    assert [c[2:] for c in started] == [
        ["serl_tpu_torch.examples.fused_peg_insert", "--seed", str(s), "--total_steps", "96000",
         "--pixels", "--success_stop", "0.9", "--log_dir", str(tmp_path / f"seed{s}")]
        for s in (0, 2)]
    args = fused_peg_insert.parser().parse_args(started[0][3:])  # the example reads them all
    assert (args.pixels, args.total_steps, args.success_stop) == (True, 96000, 0.9)
