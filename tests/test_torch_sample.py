"""Replay sampling and K4's plain version against serl_tpu's, on the CPU.

Both buffers are filled with the same numpy transitions past a wrap of the
ring, with episodes that end mid-ring in some streams (ep_id boundaries),
with next_observations stored and not. K4's plain version must equal
`ReplayBuffer._gather_batch_aligned` on the same slot indices exactly (a
gather is a copy), and `sample` must equal JAX's `sample` given JAX's own
index draws, in the stream-aligned branch and the unaligned one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from serl_tpu_torch.data import replay_buffer as rbmod
from serl_tpu_torch.data.replay_buffer import ReplayBuffer

SLOTS, STREAMS, OBS, ACT = 12, 4, 5, 2


def _example():
    return {"observations": np.zeros(OBS, np.float32), "actions": np.zeros(ACT, np.float32),
            "next_observations": np.zeros(OBS, np.float32), "rewards": np.float32(0),
            "masks": np.float32(0), "dones": np.float32(0)}


def _filled(store_next_obs, inserts=17, seed=0):
    """(jax buffer, jax state, port buffer, port state) after `inserts`
    lockstep inserts into a SLOTS-slot ring (a wrap when inserts > SLOTS)."""
    rng = np.random.default_rng(seed)
    jrb = JaxReplayBuffer({k: jnp.asarray(v) for k, v in _example().items()}, SLOTS * STREAMS,
                          store_next_obs=store_next_obs)
    trb = ReplayBuffer({k: torch.as_tensor(v) for k, v in _example().items()}, SLOTS * STREAMS,
                       store_next_obs=store_next_obs, device="cpu")
    jstate, tstate = jrb.init_state(STREAMS), trb.init_state(STREAMS)
    episode = np.zeros(STREAMS, np.int32)
    lengths = np.array([3, 5, 7, 100])  # stream 3 never ends an episode
    for t in range(inserts):
        tr = {"observations": rng.normal(size=(STREAMS, OBS)), "actions": rng.normal(size=(STREAMS, ACT)),
              "next_observations": rng.normal(size=(STREAMS, OBS)), "rewards": rng.normal(size=STREAMS),
              "masks": np.ones(STREAMS), "dones": np.zeros(STREAMS)}
        tr = {k: v.astype(np.float32) for k, v in tr.items()}
        ep_ids = (episode * STREAMS + np.arange(STREAMS)).astype(np.int32)
        jstate = jrb.insert(jstate, {k: jnp.asarray(v) for k, v in tr.items()}, jnp.asarray(ep_ids))
        tstate = trb.insert(tstate, {k: torch.from_numpy(v) for k, v in tr.items()},
                            torch.from_numpy(ep_ids))
        episode += ((t + 1) % lengths == 0)
    return jrb, jstate, trb, tstate


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("store_next_obs", [True, False])
def test_torch_gather_plain_matches_jax(store_next_obs):
    jrb, jstate, trb, tstate = _filled(store_next_obs)
    assert tstate.insert_slot == int(jstate.insert_slot) == 17 % SLOTS and tstate.size == SLOTS
    np.testing.assert_array_equal(tstate.ep_id.numpy(), np.asarray(jstate.ep_id))
    assert len(np.unique(np.asarray(jstate.ep_id)[:, 0])) > 2  # boundaries in the ring
    rng = np.random.default_rng(1)
    s2 = rng.integers(0, SLOTS, size=(6, STREAMS))
    s2[0] = SLOTS - 1  # successors that wrap to slot 0
    want = jrb._gather_batch_aligned(jstate, jnp.asarray(s2, jnp.int32))
    got = rbmod.gather_batch_aligned_plain(tstate.data, tstate.ep_id, torch.from_numpy(s2),
                                           store_next_obs)
    _equal(got, want)
    assert got["observations"].shape == (6 * STREAMS, OBS)
    before = rbmod.gather_batch_aligned.launches
    _equal(rbmod.gather_batch_aligned(tstate.data, tstate.ep_id, torch.from_numpy(s2),
                                      store_next_obs), want)
    assert rbmod.gather_batch_aligned.launches == before  # CPU: the plain version
    with pytest.raises(ValueError):
        rbmod.gather_batch_aligned_cuda(tstate.data, tstate.ep_id, torch.from_numpy(s2),
                                        store_next_obs)


@pytest.mark.parametrize("store_next_obs", [True, False])
@pytest.mark.parametrize("batch", [8, 10])  # 8: stream-aligned; 10: unaligned
def test_torch_sample_matches_jax(store_next_obs, batch):
    jrb, jstate, trb, tstate = _filled(store_next_obs, inserts=9)  # ring not yet full
    key = jax.random.PRNGKey(3)
    want = jrb.sample(jstate, key, batch)
    n_valid = max(tstate.size - (0 if store_next_obs else 1), 1)
    if batch % STREAMS == 0:
        u = jax.random.randint(key, (batch // STREAMS, STREAMS), 0, n_valid)
        got = trb.sample(tstate, batch, u=torch.from_numpy(np.asarray(u, np.int64)))
    else:
        ks, ke = jax.random.split(key)
        u = jax.random.randint(ks, (batch,), 0, n_valid)
        e = jax.random.randint(ke, (batch,), 0, STREAMS)
        got = trb.sample(tstate, batch, u=torch.from_numpy(np.asarray(u, np.int64)),
                         e=torch.from_numpy(np.asarray(e, np.int64)))
    _equal(got, want)
    drawn = trb.sample(tstate, batch, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {k: tuple(v.shape) for k, v in got.items()}


def test_torch_sample_raises_for_pixels():
    # stored next observations are read from the ring, so a ring without them raises
    trb = ReplayBuffer({"observations": torch.zeros(3)}, 8, image_keys=("front",), device="cpu")
    with pytest.raises(KeyError, match="next_observations"):
        trb.sample(trb.init_state(streams=2), 4)


@pytest.mark.cuda
def test_torch_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    for store_next_obs in (True, False):
        _, _, _, tstate = _filled(store_next_obs)
        data = {k: v.cuda() for k, v in tstate.data.items()}
        ep_id = tstate.ep_id.cuda()
        s2 = torch.randint(0, SLOTS, (6, STREAMS), device="cuda")
        before = rbmod.gather_batch_aligned.launches
        got = rbmod.gather_batch_aligned(data, ep_id, s2, store_next_obs)
        assert rbmod.gather_batch_aligned.launches == before + 1
        want = rbmod.gather_batch_aligned_plain(data, ep_id, s2, store_next_obs)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
