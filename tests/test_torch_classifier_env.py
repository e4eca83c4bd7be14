"""`ClassifierRewardEnv` and its loop against serl_tpu's, on the CPU.

The wrapper runs over the CABLE_ROUTE_CONFIG pose task at 32 px with its
time limit cut to 3 steps (so episodes end inside the test), N = 4 envs,
and a narrow float32 BinaryClassifier whose perturbed flax params both
packages hold (tests/test_torch_classifier.py's). The threshold is set in
the largest gap between the envs' logits, so that some envs succeed and
some do not. Each step is replayed through JAX's vmapped wrapper from the
port's own state before it (reset draws: JAX's, from its key chain).

Tolerances. The logits of the same frame: 2e-5 abs. Frames rendered by the
two packages from states one control step apart in float32 may differ at
edge pixels (tests/torch_k2.py's rule), which moves a logit by up to
LOGIT_ATOL; so a reward, success or done is held only where
|sigmoid(logit) - threshold| exceeds MARGIN in both packages, and at most a
quarter of the (env, step) pairs may fall inside the margin. States: t and
ep_id exactly, joint angles to 1e-4 (one control step or a 5-step settled
reset apart in float32; tests/test_torch_tasks.py holds the physics).
Wrapped rollouts are never held as long trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.envs import tasks as jtasks
from serl_tpu.envs import wrappers as jwrappers
from serl_tpu.envs.wrappers import add_stack_axis as jadd_stack_axis
from serl_tpu.envs.wrappers import serl_obs as jserl_obs
from serl_tpu_torch.data.demos import collect_episodes
from serl_tpu_torch.envs import tasks
from serl_tpu_torch.envs.wrappers import ClassifierRewardEnv, add_stack_axis, serl_obs
from serl_tpu_torch.examples import fused_cable_route, learning_check
from serl_tpu_torch.training.launcher import make_drq_agent, make_pixel_replay_buffer
from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop
from tests.test_torch_classifier import KEY, _narrow_pair_with_params
from tests.torch_pose_jax import jax_reset_draws, to_jax

N, LIMIT, SIZE = 4, 3, 32
CFG = tasks.CABLE_ROUTE_CONFIG._replace(time_limit_steps=LIMIT)
JCFG = jtasks.CABLE_ROUTE_CONFIG._replace(time_limit_steps=LIMIT)
ATOL_LOGIT_SAME_FRAME = 2e-5
LOGIT_ATOL = 0.02
MARGIN = 0.01
QPOS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_CACHE = {}


def _setup():
    """(port env, JAX env, JAX classifier def, port classifier, params), once per file."""
    if not _CACHE:
        jdef, tdef, params = _narrow_pair_with_params(21)
        env = tasks.PandaPoseTaskEnv(CFG, image_obs=True, render_size=SIZE, device="cpu")
        jenv = jtasks.PandaPoseTaskEnv(config=JCFG, image_obs=True, render_size=SIZE)
        _CACHE.update(env=env, jenv=jenv, jdef=jdef, tdef=tdef, params=params)
    c = _CACHE
    return c["env"], c["jenv"], c["jdef"], c["tdef"], c["params"]


class Recorder:
    """The port's classifier, recording every batch of frames it is shown."""

    def __init__(self, tdef):
        self.tdef, self.seen = tdef, []

    @torch.no_grad()
    def __call__(self, obs):
        self.seen.append(obs[KEY].clone())
        return self.tdef(obs)


def _split_threshold(logits):
    """sigmoid of the midpoint of the largest gap between sorted logits."""
    s = np.sort(np.asarray(logits, np.float64))
    i = int(np.argmax(np.diff(s)))
    return float(1.0 / (1.0 + np.exp(-0.5 * (s[i] + s[i + 1]))))


def _sig(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _jax_pair(jenv, jdef, params, threshold):
    """JAX's wrapped step and step_auto_reset, vmapped over the envs: jitted
    once per file, with the params and the threshold as arguments."""
    if "jstep" not in _CACHE:
        def wrapper(p, thr):
            return jwrappers.ClassifierRewardEnv(jenv, jdef.apply, p, image_key=KEY,
                                                 threshold=thr)

        _CACHE["jstep"] = jax.jit(lambda p, thr, s, a: jax.vmap(wrapper(p, thr).step)(s, a))
        _CACHE["jauto"] = jax.jit(
            lambda p, thr, s, a: jax.vmap(wrapper(p, thr).step_auto_reset)(s, a))
    p, thr = jax.tree.map(jnp.asarray, params), jnp.float32(threshold)
    return (lambda s, a: _CACHE["jstep"](p, thr, s, a),
            lambda s, a: _CACHE["jauto"](p, thr, s, a))


def _reset(env, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    state, obs = env.reset(N, draws=jax_reset_draws(keys, CFG))
    return state, obs, jax.vmap(lambda k: jax.random.split(k, 4)[3])(keys)


def test_torch_classifier_batched_equals_per_env_img_none():
    """The port classifies (N, 1, H, W, C) at once; JAX one env at a time
    ({key: img[None]}, folded into an unbatched image): the same logits."""
    env, _, jdef, tdef, params = _setup()
    _, obs, _ = _reset(env, 0)
    imgs = obs["images"][KEY]
    got = tdef({KEY: imgs.unsqueeze(1)})
    per_env = jax.vmap(lambda img: jdef.apply({"params": params}, {KEY: img[None]}))(
        jnp.asarray(imgs.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(per_env),
                               atol=ATOL_LOGIT_SAME_FRAME, rtol=0)
    for i in range(N):  # row by row, the port's own single-env call
        one = tdef({KEY: imgs[i:i + 1].unsqueeze(1)})
        np.testing.assert_allclose(one.detach().numpy(), got[i:i + 1].detach().numpy(),
                                   atol=1e-6, rtol=0)


def test_torch_classifier_env_step_and_auto_reset_match_jax():
    env, jenv, jdef, tdef, params = _setup()
    state, obs, jrng = _reset(env, 1)
    g = torch.Generator().manual_seed(0)
    actions = [torch.rand((N, 7), generator=g) * 0.4 - 0.2 for _ in range(LIMIT)]
    # the threshold splits the envs' logits at the last step: there some end
    # on a classifier success, the others at the time limit
    probe = state
    for a in actions:
        probe, pobs = env.step(probe, a)[:2]
    threshold = _split_threshold(tdef({KEY: pobs["images"][KEY].unsqueeze(1)}).detach().numpy())
    recorder = Recorder(tdef)
    wrapped = ClassifierRewardEnv(env, recorder, image_key=KEY, threshold=threshold)
    assert wrapped.time_limit_steps == LIMIT and wrapped.ACTION_DIM == 7
    jstep, jauto = _jax_pair(jenv, jdef, params, threshold)
    held = inside = 0
    successes, limits = 0, 0
    for t in range(LIMIT):
        js = to_jax(state, jrng)
        ja = jnp.asarray(actions[t].numpy())
        auto = t == LIMIT - 1  # the last step ends every episode: the time limit or success
        recorder.seen.clear()
        if auto:
            draws = jax_reset_draws(jax.vmap(jax.random.fold_in)(jrng, jnp.asarray(
                state.ep_id.numpy())), CFG)
            new, nobs, rew, done, info = wrapped.step_auto_reset(state, actions[t], draws=draws)
            jnew, jobs, jrew, jdone, jinfo = jauto(js, ja)
        else:
            new, nobs, rew, done, info = wrapped.step(state, actions[t])
            jnew, jobs, jrew, jdone, jinfo = jstep(js, ja)
        # the classifier saw the stepped frames, one batch of N, not a reset one
        assert len(recorder.seen) == 1
        stepped = info["final_obs"] if auto else nobs
        assert torch.equal(recorder.seen[0][:, 0], stepped["images"][KEY])
        logits = tdef({KEY: stepped["images"][KEY].unsqueeze(1)}).detach().numpy()
        jframes = (jinfo["final_obs"] if auto else jobs)["images"][KEY]
        jlogits = np.asarray(jax.vmap(lambda img: jdef.apply({"params": params},
                                                             {KEY: img[None]}))(jframes))
        np.testing.assert_allclose(logits, jlogits, atol=LOGIT_ATOL, rtol=0)
        ok = (np.abs(_sig(logits) - threshold) > MARGIN) & (np.abs(_sig(jlogits) - threshold)
                                                           > MARGIN)
        held += int(ok.sum())
        inside += int((~ok).sum())
        for k, got, want in (("reward", rew, jrew), ("done", done, jdone),
                             ("success", info["success"], jinfo["success"])):
            np.testing.assert_array_equal(got.numpy()[ok], np.asarray(want)[ok], err_msg=k)
        np.testing.assert_array_equal(info["pose_success"].numpy(), np.asarray(
            jinfo["pose_success"]))
        # reward = success; done = the time limit or success, never the inner env's own
        assert torch.equal(rew, info["success"])
        limit = (state.t + 1 >= LIMIT).float()
        assert torch.equal(done, torch.maximum(limit, rew))
        successes += int(rew.sum())
        limits += int(((limit > 0) & (rew == 0)).sum())
        np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
        np.testing.assert_array_equal(new.ep_id.numpy(), np.asarray(jnew.ep_id))
        np.testing.assert_allclose(new.physics.qpos.numpy(), np.asarray(jnew.physics.qpos),
                                   atol=QPOS_ATOL, rtol=0)
        state, jrng = new, jnew.rng
    assert successes >= 1 and limits >= 1  # a classifier success and a time-limit end
    assert inside <= (held + inside) // 4
    # after the auto-reset every env starts over (t 0, ep_id 1) and its
    # observation is the reset one (a second render)
    assert (state.t == 0).all() and (state.ep_id == 1).all()
    np.testing.assert_allclose(serl_obs(nobs)["state"].numpy(),
                               np.asarray(jserl_obs(jobs)["state"]), atol=1e-4, rtol=0)


def test_torch_collect_episodes_over_the_wrapper():
    """Auto-reset demos through the wrapper: each row's reward is the
    classifier's verdict on its stored next observation (the pre-reset
    frame), dones are the time limit or that success, and ep_ids chain."""
    env, _, _, tdef, _ = _setup()
    streams, steps = 2, 5
    _, obs, _ = _reset(env, 2)
    threshold = _split_threshold(tdef({KEY: obs["images"][KEY].unsqueeze(1)}).detach().numpy())
    recorder = Recorder(tdef)
    wrapped = ClassifierRewardEnv(env, recorder, image_key=KEY, threshold=threshold)
    g = torch.Generator().manual_seed(3)
    trs = collect_episodes(wrapped, lambda s, gen: torch.rand((streams, 7), generator=gen) * 0.2
                           - 0.1, g, num_episodes=streams, episode_len=steps, pixel_obs=True,
                           auto_reset=True)
    assert len(recorder.seen) == steps
    nxt = trs["next_observations"][KEY]  # (streams * steps, H, W, 3), stream-major
    seen = torch.stack([s[:, 0] for s in recorder.seen], 1).flatten(0, 1)
    assert torch.equal(seen, nxt)  # the classifier saw the stored next observations
    want = (torch.sigmoid(tdef({KEY: nxt.unsqueeze(1)})) >= threshold).float()
    assert torch.equal(trs["rewards"], want) and torch.equal(trs["success"], want)
    ep = trs["ep_ids"].view(streams, steps)
    done = trs["dones"].view(streams, steps)
    for s in range(streams):
        t = 0
        for k in range(steps):
            t += 1
            assert bool(done[s, k]) == bool(t >= LIMIT or trs["success"].view(streams, steps)[s, k])
            if done[s, k]:
                t = 0
        assert (ep[s, 1:] - ep[s, :-1] == streams * done[s, :-1].long()).all()
    assert done.sum() >= 1


def test_torch_fused_loop_over_the_wrapper_matches_jax(monkeypatch):
    env, jenv, jdef, tdef, params = _setup()
    _, obs, _ = _reset(env, 4)
    threshold = _split_threshold(tdef({KEY: obs["images"][KEY].unsqueeze(1)}).detach().numpy())
    wrapped = ClassifierRewardEnv(env, lambda o: tdef(o).detach(), image_key=KEY,
                                  threshold=threshold)
    _, jauto = _jax_pair(jenv, jdef, params, threshold)
    config = LoopConfig(num_envs=N, batch_size=8, utd_ratio=2, training_starts=10_000,
                        random_steps=10_000, buffer_capacity=64)
    rb = make_pixel_replay_buffer(64, image_size=SIZE, state_dim=tasks.PIXEL_STATE_DIM,
                                  action_dim=7, device="cpu")
    sample = {"state": torch.zeros(1, tasks.PIXEL_STATE_DIM),
              **{k: torch.zeros(1, 1, SIZE, SIZE, 3, dtype=torch.uint8) for k in rb.image_keys}}
    agent = make_drq_agent(0, sample, torch.zeros(1, 7), image_keys=rb.image_keys,
                           device="cpu")
    init_fn, run_chunk = make_fused_loop(wrapped, rb, config,
                                         expert_fn=fused_cable_route.pose_expert(CFG))
    pending = []
    monkeypatch.setattr(env, "sample_reset_draws", lambda n, g=None: pending.pop())
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    pending.append(jax_reset_draws(keys, CFG))
    jrng = jax.vmap(lambda k: jax.random.split(k, 4)[3])(keys)
    carry = init_fn(agent, 0)
    held = inside = resets = 0
    for t in range(LIMIT + 1):
        before = carry.env_states
        pending.append(jax_reset_draws(jax.vmap(jax.random.fold_in)(
            jrng, jnp.asarray(before.ep_id.numpy())), CFG))
        carry, _ = run_chunk(carry, 1)
        stored = {k: v[t] for k, v in carry.rb_state.data.items() if k != "observations"}
        jnew, jobs, jrew, jdone, jinfo = jauto(to_jax(before, jrng),
                                               jnp.asarray(stored["actions"].numpy()))
        jlogits = np.asarray(jax.vmap(lambda img: jdef.apply({"params": params},
                                                             {KEY: img[None]}))(
            jinfo["final_obs"]["images"][KEY]))
        ok = np.abs(_sig(jlogits) - threshold) > MARGIN
        held, inside = held + int(ok.sum()), inside + int((~ok).sum())
        for k in ("rewards", "dones"):
            np.testing.assert_array_equal(stored[k].numpy()[ok],
                                          np.asarray(jrew if k == "rewards" else jdone)[ok],
                                          err_msg=k)
        np.testing.assert_array_equal(stored["masks"].numpy(), 1.0 - stored["dones"].numpy())
        np.testing.assert_array_equal(carry.rb_state.ep_id[t].numpy(),
                                      before.ep_id.numpy() * N + np.arange(N))
        np.testing.assert_array_equal(carry.env_states.t.numpy(), np.asarray(jnew.t))
        np.testing.assert_array_equal(carry.env_states.ep_id.numpy(), np.asarray(jnew.ep_id))
        np.testing.assert_allclose(carry.env_states.physics.qpos.numpy(),
                                   np.asarray(jnew.physics.qpos), atol=QPOS_ATOL, rtol=0)
        # the loop's next observation is the post-reset one
        np.testing.assert_allclose(carry.obs["state"].numpy(),
                                   np.asarray(jserl_obs(jobs)["state"]), atol=1e-4, rtol=0)
        resets += int(np.asarray(jdone).sum())
        jrng = jnew.rng
    assert resets >= N and inside <= (held + inside) // 4


def test_torch_cable_route_and_learning_check_flags(tmp_path, monkeypatch):
    args = fused_cable_route.parser().parse_args([])
    assert (args.num_envs, args.batch_size, args.utd_ratio, args.image_size, args.num_demos,
            args.classifier_epochs, args.intervention_prob, args.total_steps,
            args.eval_period, args.success_stop) == (16, 256, 4, 128, 20, 300, 0.3, 60_000,
                                                     4000, 0.9)
    config = fused_cable_route.loop_config(args, demos=True)
    assert (config.updates_per_iter, config.training_starts, config.random_steps,
            config.buffer_capacity, config.demo_fraction, config.intervention_mode) == (
        2, 1000, 1000, 20_000, 0.5, "episode")
    assert fused_cable_route.THRESHOLD == 0.75 and fused_cable_route.CHUNK == 10
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
    assert learning_check.main(["--out", str(tmp_path), "--example", "fused_cable_route",
                                "--seeds", "0", "1", "2", "--total_env_steps", "60000",
                                "--success_stop", "0.9"]) == 0
    assert [c[2:6] for c in started] == [["serl_tpu_torch.examples.fused_cable_route", "--seed",
                                          str(s), "--total_steps"] for s in (0, 1, 2)]
    parsed = fused_cable_route.parser().parse_args(started[0][3:])  # the example reads them all
    assert (parsed.total_steps, parsed.success_stop) == (60_000, 0.9)


def test_torch_cable_route_classifier_phase_runs(monkeypatch):
    """train_classifier at a tiny size: K3's crop of (128, 1, H, W, 3) batches
    (num_batch_dims 2), BCE steps, the data counts; the hard-coded (8, 7)
    random policy and the per-env noisy expert."""
    env, *_ = _setup()
    states, _ = env.reset(8, torch.Generator().manual_seed(0))
    assert fused_cable_route.random_policy(states, torch.Generator()).shape == (8, 7)
    expert = fused_cable_route.pose_expert(CFG)
    noisy = fused_cable_route.noisy_expert(expert, 0.5)(states, torch.Generator().manual_seed(1))
    assert noisy.shape == (8, 7) and (noisy - expert(states)).abs().max() > 0
    assert (noisy[0] - expert(states)[0] != noisy[1] - expert(states)[1]).any()  # per env
    g = torch.Generator().manual_seed(2)
    pos = torch.randint(100, 256, (5, 1, SIZE, SIZE, 3), generator=g, dtype=torch.uint8)
    neg = torch.randint(0, 100, (7, 1, SIZE, SIZE, 3), generator=g, dtype=torch.uint8)
    args = fused_cable_route.parser().parse_args(["--device", "cpu"])
    lines = []
    out = type("Out", (), {"write": lambda self, s: lines.append(s), "flush": lambda self: None})()
    state, info = fused_cable_route.train_classifier(env, expert, args, out, frames=(pos, neg),
                                                     epochs=3)
    assert (info["positives"], info["negatives"]) == (5, 7) and state.step == 3
    assert np.isfinite(info["loss"]) and 0.0 <= info["accuracy"] <= 1.0
    assert any("classifier data: 5 positives, 7 negatives" in s for s in lines)


def test_torch_classifier_env_wraps_the_pick_env():
    """Over the pick env (its resets are cube positions): the verdict on the
    stepped frame is the reward, and an ended episode takes the fresh reset."""
    from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv

    _, _, _, tdef, _ = _setup()
    env = PandaPickCubeEnv(image_obs=True, render_size=SIZE, device="cpu")
    g = torch.Generator().manual_seed(6)
    state, obs = env.reset(N, g)
    logits = tdef({KEY: obs["images"][KEY].unsqueeze(1)}).detach()
    threshold = float(torch.sigmoid(logits).min()) - 0.01  # every env succeeds
    wrapped = ClassifierRewardEnv(env, lambda o: tdef(o).detach(), image_key=KEY,
                                  threshold=threshold)
    assert wrapped.ACTION_DIM == 4
    xy = env.sample_reset_xy(N, g)
    new, nobs, rew, done, info = wrapped.step_auto_reset(state, torch.zeros(N, 4), draws=xy)
    assert (rew == 1).all() and (done == 1).all() and (info["pose_success"] == 0).all()
    assert (new.t == 0).all() and (new.ep_id == 1).all()
    want = env._fresh(xy, torch.ones(N, dtype=torch.int32))
    assert torch.equal(new.physics.cube_pos, want.physics.cube_pos)
    assert torch.equal(nobs["images"][KEY], env._obs(want)["images"][KEY])
    assert not torch.equal(info["final_obs"]["images"][KEY], nobs["images"][KEY])
