"""The port's replay-buffer insert against serl_tpu's, on the CPU: the same
transitions (from numpy) go into both rings, over a wrap-around; stored rows
must be identical (an insert is a copy, so the tolerance is zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.training.launcher import make_state_replay_buffer as jax_buffer
from serl_tpu_torch.training.launcher import _round_up, make_state_replay_buffer


def _transitions(rng, streams):
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {
        "observations": f(streams, 10),
        "actions": f(streams, 4),
        "next_observations": f(streams, 10),
        "rewards": f(streams),
        "masks": np.ones(streams, np.float32),
        "dones": np.zeros(streams, np.float32),
    }


def test_torch_buffer_insert_wraps_like_jax():
    streams, capacity = 4, 12  # 3 slots per stream
    jrb, trb = jax_buffer(capacity), make_state_replay_buffer(capacity, device="cpu")
    js, ts = jrb.init_state(streams), trb.init_state(streams)
    assert ts.ep_id.shape == (3, streams) and int(ts.ep_id.min()) == -1
    rng = np.random.default_rng(0)
    for step in range(5):  # 5 inserts into 3 slots: two overwrite the oldest rows
        tr = _transitions(rng, streams)
        ep = (np.arange(streams) + streams * (step // 2)).astype(np.int32)
        js = jrb.insert(js, {k: jnp.asarray(v) for k, v in tr.items()}, jnp.asarray(ep))
        ts = trb.insert(ts, {k: torch.from_numpy(v) for k, v in tr.items()}, torch.from_numpy(ep))
        assert ts.insert_slot == int(js.insert_slot) and ts.size == int(js.size)
    assert (ts.insert_slot, ts.size) == (2, 3)
    np.testing.assert_array_equal(ts.ep_id.numpy(), np.asarray(js.ep_id))
    for k in js.data:
        np.testing.assert_array_equal(ts.data[k].numpy(), np.asarray(js.data[k]), err_msg=k)
        assert ts.data[k].shape == (3, streams) + tuple(js.data[k].shape[2:])


def test_torch_buffer_capacity_must_divide_by_streams():
    with pytest.raises(ValueError):
        make_state_replay_buffer(10, device="cpu").init_state(4)
    assert _round_up(100_000, 128) == 100_096 and _round_up(256, 128) == 256
