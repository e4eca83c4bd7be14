"""The task-routed replay buffer against serl_tpu's, on the CPU.

- Masked inserts: the same rows, episode ids and (streams,) masks through
  both packages leave the same ring, cursors and sizes, exactly; a
  masked-out stream keeps its cursor, size and rows; a full stream wraps and
  a masked-out full stream loses no row.
- Sampling over per-stream windows of unequal sizes, one stream never
  written (it samples its cursor slot: a zero row, ep_id -1): with the
  offsets JAX draws from its key (floor(uniform * max(size - sub, 1))),
  the port's batch equals JAX's exactly, next observations stored and not,
  flat and pixel (frame stacks T = 1) observations.
- `sample_mixed` of an online routed ring and a routed demo ring with
  another stream count (the fwbw layout: 32 and 16 streams, here 4 and 2):
  exactly JAX's with JAX's draws, rows interleaved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.data.routed_buffer import RoutedReplayBuffer as JaxRouted
from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer

SLOTS, STREAMS, OBS, ACT = 6, 4, 5, 3


def _example(pixels=False, store_next_obs=True):
    if pixels:
        img = np.zeros((8, 8, 3), np.uint8)
        ex = {"observations": {"state": np.zeros((OBS,), np.float32), "front": img},
              "actions": np.zeros((ACT,), np.float32), "rewards": np.zeros((), np.float32),
              "masks": np.zeros((), np.float32), "dones": np.zeros((), np.float32)}
    else:
        ex = {"observations": np.zeros((OBS,), np.float32), "actions": np.zeros((ACT,), np.float32),
              "next_observations": np.zeros((OBS,), np.float32),
              "rewards": np.zeros((), np.float32), "masks": np.zeros((), np.float32),
              "dones": np.zeros((), np.float32)}
    return ex


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _buffers(pixels=False, store_next_obs=True, streams=STREAMS, slots=SLOTS):
    ex = _example(pixels)
    kw = dict(store_next_obs=store_next_obs, image_keys=("front",) if pixels else ())
    jrb = JaxRouted(_map(jnp.asarray, ex), capacity=slots * streams, **kw)
    trb = RoutedReplayBuffer(_map(torch.from_numpy, ex), capacity=slots * streams, device="cpu",
                             **kw)
    return jrb, trb


def _rows(rng, streams, pixels=False):
    obs = rng.normal(size=(streams, OBS)).astype(np.float32)
    if pixels:
        obs = {"state": obs, "front": rng.integers(0, 256, (streams, 8, 8, 3), dtype=np.uint8)}
    tr = {"observations": obs, "actions": rng.normal(size=(streams, ACT)).astype(np.float32),
          "rewards": rng.normal(size=(streams,)).astype(np.float32),
          "masks": np.ones((streams,), np.float32), "dones": np.zeros((streams,), np.float32)}
    if not pixels:
        tr["next_observations"] = rng.normal(size=(streams, OBS)).astype(np.float32)
    return tr


def _fill(jrb, trb, masks, pixels=False, seed=0):
    """Both rings after one insert per mask row; episode ids change every 3
    inserts of a stream."""
    streams = masks.shape[1]
    rng = np.random.default_rng(seed)
    js, ts = jrb.init_state(streams), trb.init_state(streams)
    count = np.zeros(streams, np.int64)
    for mask in masks:
        tr = _rows(rng, streams, pixels)
        ep = ((count // 3) * streams + np.arange(streams)).astype(np.int32)
        js = jrb.insert(js, _map(jnp.asarray, tr), jnp.asarray(ep), mask=jnp.asarray(mask))
        ts = trb.insert(ts, _map(torch.from_numpy, tr), torch.from_numpy(ep),
                        mask=torch.from_numpy(mask))
        count += mask
    return js, ts


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


def _check_state(ts, js):
    _equal(ts.data, js.data, "data")
    _equal(ts.ep_id, js.ep_id, "ep_id")
    _equal(ts.insert_slot, js.insert_slot, "insert_slot")
    _equal(ts.size, js.size, "size")


# unequal streams: 0 never written, 1 twice, 2 wraps (fills, then is masked
# out for the rest), 3 every other insert
MASKS = np.stack([np.array([False, i < 2, i < SLOTS + 2, i % 2 == 0]) for i in range(14)])


@pytest.mark.parametrize("pixels", [False, True])
def test_torch_masked_insert_matches_jax(pixels):
    jrb, trb = _buffers(pixels, store_next_obs=not pixels)
    js, ts = _fill(jrb, trb, MASKS, pixels)
    _check_state(ts, js)
    np.testing.assert_array_equal(ts.size.numpy(), [0, 2, SLOTS, min(7, SLOTS)])
    # a masked-out full stream keeps every row: one more insert with stream 2 masked out
    before = {k: v.clone() for k, v in ts.data.items()} if not pixels else None
    rng = np.random.default_rng(99)
    mask = np.array([True, True, False, True])
    tr = _rows(rng, STREAMS, pixels)
    ep = np.arange(STREAMS, dtype=np.int32) + 100
    js = jrb.insert(js, _map(jnp.asarray, tr), jnp.asarray(ep), mask=jnp.asarray(mask))
    ts = trb.insert(ts, _map(torch.from_numpy, tr), torch.from_numpy(ep),
                    mask=torch.from_numpy(mask))
    _check_state(ts, js)
    if before is not None:
        for k, v in ts.data.items():
            assert torch.equal(v[:, 2], before[k][:, 2]), k
    assert int(ts.insert_slot[0]) == 1 and int(ts.size[0]) == 1


def _jax_u(key, js, rows, store_next_obs):
    """The offsets JAX's RoutedReplayBuffer._sample_aligned draws from `key`."""
    sub = 0 if store_next_obs else 1
    n_valid = np.maximum(np.asarray(js.size) - sub, 1)
    uni = np.asarray(jax.random.uniform(key, (rows, n_valid.shape[0])))
    return torch.from_numpy(np.floor(uni * n_valid.astype(np.float32)).astype(np.int64))


@pytest.mark.parametrize("pixels,store_next_obs", [(False, True), (False, False), (True, False)])
def test_torch_routed_sample_matches_jax(pixels, store_next_obs):
    jrb, trb = _buffers(pixels, store_next_obs)
    js, ts = _fill(jrb, trb, MASKS, pixels, seed=1)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jrb.sample(js, key, 12)
        got = trb.sample(ts, 12, u=_jax_u(key, js, 3, store_next_obs))
        _equal(got, want)
        # stream 0 was never written: its rows are the cursor slot's zeros
        obs = got["observations"]["state"] if pixels else got["observations"]
        assert (obs[:3] == 0).all()
    with pytest.raises(ValueError):
        trb.sample(ts, 10)
    # the generator's draws stay in each stream's window
    got = trb.sample(ts, 400, generator=torch.Generator().manual_seed(0))
    assert got["rewards"].shape == (400,)


def test_torch_routed_sample_mixed_matches_jax():
    jrb, trb = _buffers(store_next_obs=True)
    jdemo, tdemo = _buffers(store_next_obs=True, streams=2, slots=5)
    js, ts = _fill(jrb, trb, MASKS, seed=2)
    demo_masks = np.stack([np.array([True, i % 3 != 0]) for i in range(9)])
    jd, td = _fill(jdemo, tdemo, demo_masks, seed=3)
    key = jax.random.PRNGKey(7)
    want = jrb.sample_mixed(js, jd, key, 16, buffer_b=jdemo)
    ka, kb = jax.random.split(key)
    got = trb.sample_mixed(ts, td, 16, buffer_b=tdemo, u_a=_jax_u(ka, js, 2, True),
                           u_b=_jax_u(kb, jd, 4, True))
    _equal(got, want)
    # rows interleave: even from the online ring, odd from the demo ring
    demo_rows = tdemo.sample(td, 8, u=_jax_u(kb, jd, 4, True))
    np.testing.assert_array_equal(got["rewards"][1::2].numpy(), demo_rows["rewards"].numpy())
