"""The loop's frame-stack history and the next_obs pixel ring against
serl_tpu, on the CPU.

- `chunk_init` / `chunk_push` (`envs/wrappers.py`) on batched and unbatched
  images and vectors: exactly JAX's (the history axis before H, W, C for
  images, before the last axis otherwise).
- A 4-env, 32 px, `num_stack=2` fused DrQ loop (the sizes of
  tests/test_loop.py::test_fused_pixel_loop_with_frame_stack), two envs near
  their time limit so that episodes end inside the run: after each
  iteration the carry's history equals JAX's loop update (loop.py:255-272:
  chunk_push of the new frames, chunk_init of the post-reset frame where an
  episode ended) replayed on the port's frames, the policy acts on the
  history it held, and the ring, fed to JAX's buffer slot by slot, samples
  JAX's stacks exactly on JAX's draws; the learner updates on stacked
  batches.
- `evaluate` with the stack: scripted agents in both frameworks whose
  actions read both frames, the same reset positions (JAX's draws), 3-step
  episodes: at each step every frame of the stacks each agent is given
  (JAX's recorded by an ordered callback) within one level in at most 0.5%
  of its pixels, the actions to 1e-3, the return to 1e-4 relative and the
  success rate exactly.
- The pixel ring that stores next_observations: both samplers give JAX's
  batch exactly on JAX's draws, the quirk included (the next_observations'
  cameras are the observations' stacks at the row itself); the loop with
  such a ring stores the pre-reset terminal frame as the successor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from serl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from serl_tpu.envs import panda_pick as jpick
from serl_tpu.envs import wrappers as jw
from serl_tpu.training import loop as jloop
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.envs import wrappers
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.training.launcher import make_drq_sim_experiment
from serl_tpu_torch.training.loop import LoopConfig, evaluate, make_fused_loop

KEYS = ("front", "wrist")
N, SIZE, T = 4, 32, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _equal(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def test_torch_chunk_init_and_push_match_jax():
    rng = np.random.default_rng(0)
    obs = {"front": rng.integers(0, 256, (3, 6, 5, 3)).astype(np.uint8),
           "state": rng.normal(size=(3, 7)).astype(np.float32),
           "one": rng.integers(0, 256, (6, 5, 3)).astype(np.uint8),
           "vec": rng.normal(size=(4,)).astype(np.float32)}
    for horizon in (1, 3):
        got = wrappers.chunk_init(_tree(torch.from_numpy, obs), horizon)
        want = jw.chunk_init(_tree(jnp.asarray, obs), horizon)
        _equal(_tree(lambda x: x.numpy(), got.frames), want.frames, f"init {horizon}")
        for step in range(2):
            new = _tree(lambda x: (x + 1 + step).astype(x.dtype), obs)
            got = wrappers.chunk_push(got, _tree(torch.from_numpy, new))
            want = jw.chunk_push(want, _tree(jnp.asarray, new))
            _equal(_tree(lambda x: x.numpy(), got.frames), want.frames, f"push {horizon} {step}")
    assert got.frames["front"].shape == (3, 3, 6, 5, 3) and got.frames["state"].shape == (3, 3, 7)


def test_torch_frame_stack_loop_matches_jax_history_and_ring():
    env, agent, rb, config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=0, device="cpu", num_stack=T, num_envs=N, image_size=SIZE, batch_size=8,
        utd_ratio=2, training_starts=16, random_steps=8, buffer_capacity=256)
    assert rb.num_stack == T and not rb.store_next_obs
    carry = init_fn(agent, 0)
    # envs 0 and 1 reach the time limit in iterations 2 and 1
    carry = carry._replace(env_states=carry.env_states._replace(
        t=torch.tensor([97, 98, 0, 50], dtype=torch.int32)))
    for k in KEYS:
        assert carry.chunk.frames[k].shape == (N, T, SIZE, SIZE, 3)
    seen = []
    inner = agent.sample_actions

    def spy(observations, **kw):
        seen.append({k: observations[k].clone() for k in KEYS})
        return inner(observations, **kw)

    agent.sample_actions = spy
    jchunk = jw.chunk_init({k: jnp.asarray(carry.obs[k].numpy()) for k in KEYS}, T)
    example = _tree(lambda x: jnp.asarray(x.numpy()), rb._example)
    jrb = JaxReplayBuffer(example, config.buffer_capacity, store_next_obs=False, image_keys=KEYS,
                          num_stack=T)
    jstate = jrb.init_state(N)
    ends = 0
    for it in range(6):
        before = {k: carry.chunk.frames[k].clone() for k in KEYS}
        carry, m = run_chunk(carry, 1)
        ring = carry.rb_state
        slot = (ring.insert_slot - 1) % ring.ep_id.shape[0]
        if it * N >= config.random_steps:  # the policy acted on the history it held
            for k in KEYS:
                assert torch.equal(seen[-1][k], before[k]), (it, k)
        # JAX's loop update of the history, on the port's frames
        done = jnp.asarray(ring.data["dones"][slot].numpy() > 0.5)
        imgs = {k: jnp.asarray(carry.obs[k].numpy()) for k in KEYS}
        pushed, fresh = jw.chunk_push(jchunk, imgs).frames, jw.chunk_init(imgs, T).frames
        jchunk = jw.ChunkState(frames=jax.tree.map(
            lambda p, f: jnp.where(done.reshape((-1,) + (1,) * (p.ndim - 1)), f, p),
            pushed, fresh))
        _equal(_tree(lambda x: x.numpy(), carry.chunk.frames), jchunk.frames, f"iteration {it}")
        ends += int(done.sum())
        # the ring, slot by slot into JAX's buffer, samples JAX's stacks
        tr = _tree(lambda x: jnp.asarray(x[slot].numpy()), ring.data)
        jstate = jrb.insert(jstate, tr, jnp.asarray(ring.ep_id[slot].numpy()))
        if ring.size >= 2:
            key = jax.random.PRNGKey(it)
            want = jrb._sample_aligned(jstate, key, 8)
            u = jax.random.randint(key, (8 // N, N), 0, max(int(jstate.size) - 1, 1))
            got = rb.sample(ring, 8, u=torch.from_numpy(np.asarray(u, np.int64)))
            _equal(_tree(lambda x: x.numpy(), got), want, f"sample {it}")
            assert got["observations"]["front"].shape == (8, T, SIZE, SIZE, 3)
    assert ends == 2
    assert agent.state.step > 0 and torch.isfinite(m["critic_loss"]).all()


_JAX_SEEN = []  # (stacks by camera, actions) of each call of _JaxStackAgent


def _record_jax(front, wrist, actions):
    _JAX_SEEN.append(({"front": np.asarray(front), "wrist": np.asarray(wrist)},
                      np.asarray(actions)))


class _JaxStackAgent(struct.PyTreeNode):
    """Actions from both frames of the front stack and the proprio; records
    the stacks it is given and its actions (an ordered callback in the
    jitted rollout)."""

    def sample_actions(self, obs, argmax=False):
        f = obs["front"].astype(jnp.float32).mean(axis=(-3, -2, -1))  # (N, T)
        a = jnp.stack([jnp.tanh((f[:, -1] - f[:, 0]) / 4.0), jnp.tanh(f[:, 0] / 255.0 - 0.5),
                       jnp.full(f.shape[:1], -0.3), jnp.tanh(obs["state"][:, 0])], -1)
        jax.debug.callback(_record_jax, obs["front"], obs["wrist"], a, ordered=True)
        return a


class _TorchStackAgent:
    def __init__(self):
        self.seen = []

    def sample_actions(self, obs, argmax=False):
        f = obs["front"].to(torch.float32).mean(dim=(-3, -2, -1))
        a = torch.stack([torch.tanh((f[:, -1] - f[:, 0]) / 4.0),
                         torch.tanh(f[:, 0] / 255.0 - 0.5), torch.full(f.shape[:1], -0.3),
                         torch.tanh(obs["state"][:, 0])], -1)
        self.seen.append(({k: obs[k].numpy().copy() for k in KEYS}, a.numpy().copy()))
        return a


# The two packages' CPU physics round apart by ~2e-4 in the proprio by the
# third step, which moves a few edge pixels by one level: each frame of the
# port's stacks is held to JAX's within 1 level in at most FRAME_SHARE of its
# pixels; successive frames differ far beyond that (checked in the test), so
# a wrong history fails. Actions to ACTION_ATOL (read off the frames' means), the
# return to RETURN_RTOL (observed 2.5e-6 relative on a return of 1.6e-4).
FRAME_SHARE = 0.005
ACTION_ATOL = 1e-3
RETURN_RTOL = 1e-4


def _frames_close(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return diff.max() <= 1 and (diff > 0).mean() <= FRAME_SHARE


def test_torch_evaluate_with_the_stack_matches_jax():
    jenv = type("Short", (jpick.PandaPickCubeEnv,), {"time_limit_steps": 3})(
        image_obs=True, render_size=SIZE)
    tenv = type("Short", (PandaPickCubeEnv,), {"time_limit_steps": 3})(
        image_obs=True, render_size=SIZE, device="cpu")
    key, episodes = jax.random.PRNGKey(5), 3
    lo, hi = jpick.SAMPLING_BOUNDS
    xy = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k, 3)[1], (2,), minval=lo,
                                               maxval=hi))(jax.random.split(key, episodes))
    tenv.sample_reset_xy = lambda n, g=None: torch.from_numpy(np.array(xy))
    _JAX_SEEN.clear()
    want = jloop.evaluate(jenv, _JaxStackAgent(), key, num_episodes=episodes, pixel_keys=KEYS,
                          num_stack=T)
    jax.effects_barrier()
    agent = _TorchStackAgent()
    got = evaluate(tenv, agent, 0, num_episodes=episodes, pixel_keys=KEYS, num_stack=T)
    assert got["eval/success_rate"] == want["eval/success_rate"]
    np.testing.assert_allclose(got["eval/return_mean"], want["eval/return_mean"],
                               rtol=RETURN_RTOL, atol=0)
    assert len(agent.seen) == len(_JAX_SEEN) == 3
    for step, ((stacks, actions), (jstacks, jactions)) in enumerate(zip(agent.seen, _JAX_SEEN)):
        for k in KEYS:
            assert stacks[k].shape == jstacks[k].shape == (episodes, T, SIZE, SIZE, 3)
            for slot in range(T):
                assert _frames_close(stacks[k][:, slot], jstacks[k][:, slot]), (step, k, slot)
        np.testing.assert_allclose(actions, jactions, atol=ACTION_ATOL, err_msg=f"step {step}")
    # the check has teeth: the front camera's newest frame moves beyond the
    # rule at every step, and at the last step each camera's two frames differ
    # beyond it (the wrist camera's first step leaves its frame unchanged)
    for (prev, _), (cur, _) in zip(_JAX_SEEN, _JAX_SEEN[1:]):
        assert not _frames_close(cur["front"][:, 1], prev["front"][:, 1])
    for k in KEYS:
        assert not _frames_close(_JAX_SEEN[-1][0][k][:, 0], _JAX_SEEN[-1][0][k][:, 1]), k


def _next_obs_rings(num_stack):
    rng = np.random.default_rng(7)
    frame = lambda *lead: rng.integers(0, 256, lead + (6, 5, 3)).astype(np.uint8)
    ex = {"observations": {"state": np.zeros(3, np.float32), **{k: frame() for k in KEYS}},
          "next_observations": {"state": np.zeros(3, np.float32), **{k: frame() for k in KEYS}},
          "actions": np.zeros(2, np.float32), "rewards": np.zeros((), np.float32),
          "masks": np.zeros((), np.float32), "dones": np.zeros((), np.float32)}
    slots, streams = 8, 4
    jrb = JaxReplayBuffer(_tree(jnp.asarray, ex), slots * streams, image_keys=KEYS,
                          num_stack=num_stack)
    trb = ReplayBuffer(_tree(torch.from_numpy, ex), slots * streams, image_keys=KEYS,
                       num_stack=num_stack, device="cpu")
    jstate, tstate = jrb.init_state(streams), trb.init_state(streams)
    for t in range(11):
        tr = _tree(lambda x: (rng.integers(0, 256, (streams,) + x.shape).astype(np.uint8)
                              if x.dtype == np.uint8 else
                              rng.normal(size=(streams,) + x.shape).astype(np.float32)), ex)
        ep = ((t // (np.arange(streams) + 2)) * streams + np.arange(streams)).astype(np.int32)
        jstate = jrb.insert(jstate, _tree(jnp.asarray, tr), jnp.asarray(ep))
        tstate = trb.insert(tstate, _tree(torch.from_numpy, tr), torch.from_numpy(ep))
    return jrb, jstate, trb, tstate


@pytest.mark.parametrize("num_stack", [1, 3])
def test_torch_next_obs_pixel_ring_keeps_the_quirk(num_stack):
    jrb, jstate, trb, tstate = _next_obs_rings(num_stack)
    slots, streams = tstate.ep_id.shape
    key = jax.random.PRNGKey(num_stack)
    u = jax.random.randint(key, (3, streams), 0, slots)
    want = jrb._sample_aligned(jstate, key, 3 * streams)
    got = trb.sample(tstate, 3 * streams, u=torch.from_numpy(np.asarray(u, np.int64)))
    _equal(_tree(lambda x: x.numpy(), got), want, "aligned")
    for k in KEYS:  # the quirk: the next cameras are the observations' stacks
        assert torch.equal(got["next_observations"][k], got["observations"][k])
    assert not torch.equal(got["next_observations"]["state"], got["observations"]["state"])
    ks, ke = jax.random.split(jax.random.PRNGKey(20 + num_stack))
    want = jrb.sample(jstate, jax.random.PRNGKey(20 + num_stack), 7)
    got = trb.sample(tstate, 7, u=torch.from_numpy(np.asarray(jax.random.randint(ks, (7,), 0, slots),
                                                              np.int64)),
                     e=torch.from_numpy(np.asarray(jax.random.randint(ke, (7,), 0, streams),
                                                   np.int64)))
    _equal(_tree(lambda x: x.numpy(), got), want, "unaligned")


def test_torch_loop_with_a_next_obs_pixel_ring_stores_the_terminal_frame():
    env = PandaPickCubeEnv(image_obs=True, render_size=SIZE, device="cpu")
    _, agent, rb, *_ = make_drq_sim_experiment(device="cpu", num_envs=2, image_size=SIZE,
                                               buffer_capacity=8)
    ex = dict(rb._example)
    ex["next_observations"] = ex["observations"]
    ring = ReplayBuffer(ex, 16, store_next_obs=True, image_keys=KEYS, device="cpu")
    init_fn, run_chunk = make_fused_loop(env, ring, LoopConfig(
        num_envs=2, batch_size=2, utd_ratio=1, training_starts=100, random_steps=100,
        buffer_capacity=16))
    carry = init_fn(agent, 0)
    carry = carry._replace(env_states=carry.env_states._replace(
        t=torch.tensor([99, 0], dtype=torch.int32)))
    carry, _ = run_chunk(carry, 2)
    d = carry.rb_state.data
    assert d["dones"][0].tolist() == [1.0, 0.0]
    for k in KEYS:
        # env 1 ran on: its successor is the next slot's observation; env 0
        # ended: its successor is the terminal frame, not the post-reset one
        assert torch.equal(d["next_observations"][k][0, 1], d["observations"][k][1, 1])
        assert not torch.equal(d["next_observations"][k][0, 0], d["observations"][k][1, 0])
