"""The pixel replay buffer (K4's uint8 frames and frame stacks) against
serl_tpu's, on the CPU.

A small ring (10 slots x 4 streams) of dict observations {"state": 3 floats,
"front"/"wrist": 6x5x3 uint8} with `store_next_obs=False`, filled past a
wrap with episodes of a different length in every stream, goes into both
packages' buffers. With the same slot indices (JAX's own draws, replayed),
the stream-aligned sample (K4's plain version, `gather_batch_aligned`)
equals `_gather_batch_aligned`, and the unaligned one equals JAX's `sample`,
exactly (both copy), at T = 1 and T = 3: frames, frame stacks clamped to the
anchor's episode, next observations rebuilt from the successor slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from serl_tpu_torch.data import replay_buffer as rbmod
from serl_tpu_torch.data.replay_buffer import ReplayBuffer

SLOTS, STREAMS, INSERTS = 10, 4, 13
KEYS = ("front", "wrist")


def _example():
    return {"observations": {"state": np.zeros(3, np.float32),
                             **{k: np.zeros((6, 5, 3), np.uint8) for k in KEYS}},
            "actions": np.zeros(2, np.float32), "rewards": np.zeros((), np.float32),
            "masks": np.zeros((), np.float32), "dones": np.zeros((), np.float32)}


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _filled(num_stack):
    rng = np.random.default_rng(num_stack)
    ex = _example()
    jrb = JaxReplayBuffer(_tree(jnp.asarray, ex), SLOTS * STREAMS, store_next_obs=False,
                          image_keys=KEYS, num_stack=num_stack)
    trb = ReplayBuffer(_tree(torch.from_numpy, ex), SLOTS * STREAMS, store_next_obs=False,
                       image_keys=KEYS, num_stack=num_stack, device="cpu")
    jstate, tstate = jrb.init_state(STREAMS), trb.init_state(STREAMS)
    lengths = np.arange(STREAMS) + 2  # stream j's episodes last j + 2 steps
    for t in range(INSERTS):
        tr = _tree(lambda x: (rng.integers(0, 256, (STREAMS,) + x.shape).astype(np.uint8)
                              if x.dtype == np.uint8 else
                              rng.normal(size=(STREAMS,) + x.shape).astype(np.float32)), ex)
        ep = ((t // lengths) * STREAMS + np.arange(STREAMS)).astype(np.int32)
        jstate = jrb.insert(jstate, _tree(jnp.asarray, tr), jnp.asarray(ep))
        tstate = trb.insert(tstate, _tree(torch.from_numpy, tr), torch.from_numpy(ep))
    return jrb, jstate, trb, tstate


def _assert_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


def _clamped_frames(tstate, s, e, num_stack):
    """How many stack frames of rows (s, e) the episode clamp replaces."""
    raw = (s[:, None] - torch.arange(num_stack - 1, -1, -1)) % SLOTS
    return int((tstate.ep_id[raw, e[:, None]] != tstate.ep_id[s, e][:, None]).sum())


@pytest.mark.parametrize("num_stack", [1, 3])
def test_torch_pixel_aligned_sample_matches_jax(num_stack):
    jrb, jstate, trb, tstate = _filled(num_stack)
    assert tstate.size == SLOTS and tstate.insert_slot == INSERTS % SLOTS  # wrapped
    key = jax.random.PRNGKey(num_stack)
    batch = 5 * STREAMS
    # _sample_aligned's draw, then the seam rows: the newest sampleable slot
    u = np.array(jax.random.randint(key, (batch // STREAMS, STREAMS), 0, SLOTS - 1))
    u[0] = SLOTS - 2
    s2 = (tstate.insert_slot - tstate.size + u) % SLOTS
    want = jrb._gather_batch_aligned(jstate, jnp.asarray(s2))
    got = trb.sample(tstate, batch, u=torch.from_numpy(u))
    _assert_equal(got, want)
    for k in KEYS:
        assert got["observations"][k].shape == (batch, num_stack, 6, 5, 3)
        assert got["next_observations"][k].dtype == torch.uint8
    assert got["observations"]["state"].shape == (batch, 3)
    if num_stack > 1:
        s = torch.from_numpy(s2.T.reshape(-1))
        e = torch.arange(STREAMS).repeat_interleave(batch // STREAMS)
        assert _clamped_frames(tstate, s, e, num_stack) > 0  # the clamp is exercised


@pytest.mark.parametrize("num_stack", [1, 3])
def test_torch_pixel_unaligned_sample_matches_jax(num_stack):
    jrb, jstate, trb, tstate = _filled(num_stack)
    key = jax.random.PRNGKey(10 + num_stack)
    batch = 7  # does not divide over the 4 streams
    want = jrb.sample(jstate, key, batch)
    ks, ke = jax.random.split(key)  # sample's own draws
    u = torch.from_numpy(np.array(jax.random.randint(ks, (batch,), 0, SLOTS - 1))).long()
    e = torch.from_numpy(np.array(jax.random.randint(ke, (batch,), 0, STREAMS))).long()
    got = trb.sample(tstate, batch, u=u, e=e)
    _assert_equal(got, want)
    if num_stack > 1:
        s = (tstate.insert_slot - tstate.size + u) % SLOTS
        assert _clamped_frames(tstate, s, e, num_stack) > 0


def test_torch_pixel_buffer_with_stored_next_obs_raises():
    # a ring that stores next observations needs them in its example, as
    # JAX's does (the quirk of such a pixel ring: tests/test_torch_frame_stack.py)
    trb = ReplayBuffer(_tree(torch.from_numpy, _example()), 40, image_keys=KEYS, device="cpu")
    with pytest.raises(KeyError, match="next_observations"):
        trb.sample(trb.init_state(STREAMS), 8)


@pytest.mark.cuda
def test_torch_pixel_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    for num_stack in (1, 3):
        _, _, _, tstate = _filled(num_stack)
        data = _tree(lambda x: x.cuda(), tstate.data)
        ep_id = tstate.ep_id.cuda()
        s2 = torch.randint(0, SLOTS, (6, STREAMS), device="cuda")
        before = rbmod.gather_batch_aligned.launches
        got = rbmod.gather_batch_aligned(data, ep_id, s2, False, KEYS, num_stack)
        assert rbmod.gather_batch_aligned.launches == before + 1
        want = rbmod.gather_batch_aligned_plain(data, ep_id, s2, False, KEYS, num_stack)
        _assert_equal(_tree(lambda x: x.cpu(), got), _tree(lambda x: x.cpu(), want))
