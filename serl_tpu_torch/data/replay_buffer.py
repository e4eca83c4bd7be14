"""Device-resident circular replay buffer: layout, init and insert.

Port of the insert side of `serl_tpu/data/replay_buffer.py`. The layout is
the same: every array is (slots, streams, ...), where `streams` is the number
of lockstep envs and `slots` the per-stream ring length; an insert writes
one full slot at the ring cursor, and `ep_id` records each row's episode so
successors and frame stacks can stop at episode boundaries. Unlike the JAX
package's pure functions, `insert` writes the state's tensors in place and
returns the same state. The cursor and size are host integers, so an insert
never waits for the device. Sampling belongs to the learner and is not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from serl_tpu_torch import resolve_device


@dataclass
class ReplayBufferState:
    """data: dict of (slots, streams, ...) tensors (observations, actions,
        rewards, masks, dones [, next_observations]).
    insert_slot: next slot (the ring cursor, shared by all streams).
    size: number of valid slots (<= slots).
    ep_id: (slots, streams) int32 episode id of each row (-1 = empty)."""

    data: Dict[str, torch.Tensor]
    insert_slot: int
    size: int
    ep_id: torch.Tensor


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


class ReplayBuffer:
    """Static spec + init/insert over `ReplayBufferState`.

    `example_transition`: dict (possibly nested) of per-row example tensors
    giving each leaf's shape and dtype. `store_next_obs=False` drops
    next_observations (the memory-efficient pixel layout)."""

    def __init__(
        self,
        example_transition: Dict,
        capacity: int,
        store_next_obs: bool = True,
        image_keys: Tuple[str, ...] = (),
        device=None,
    ):
        self.capacity = int(capacity)
        self.store_next_obs = bool(store_next_obs)
        self.image_keys = tuple(image_keys)  # pixel sampling is not ported yet
        self.device = resolve_device(device)
        example = dict(example_transition)
        if not store_next_obs:
            example.pop("next_observations", None)
        self._example = _map(torch.as_tensor, example)

    def init_state(self, streams: int = 1) -> ReplayBufferState:
        """`streams` = rows inserted per control step (the lockstep env
        count). Total row capacity is `capacity`, so each stream's ring has
        `capacity // streams` slots."""
        streams = int(streams)
        if self.capacity % streams != 0:
            raise ValueError(
                f"capacity {self.capacity} must be a multiple of the stream count {streams}"
            )
        slots = self.capacity // streams
        return ReplayBufferState(
            data=_map(
                lambda x: torch.zeros((slots, streams) + tuple(x.shape), dtype=x.dtype,
                                      device=self.device),
                self._example,
            ),
            insert_slot=0,
            size=0,
            ep_id=torch.full((slots, streams), -1, dtype=torch.int32, device=self.device),
        )

    def insert(self, state: ReplayBufferState, transitions: Dict,
               ep_ids: torch.Tensor) -> ReplayBufferState:
        """Write one lockstep slot in place: `transitions` leaves are
        (streams, ...); `ep_ids` (streams,) episode identifiers (e.g.
        env_index + episode_count * num_envs)."""
        tr = dict(transitions)
        if not self.store_next_obs:
            tr.pop("next_observations", None)
        slot = state.insert_slot
        slots = state.ep_id.shape[0]

        def write(buf, x):
            buf[slot] = x
            return buf

        _map2(write, state.data, {k: tr[k] for k in state.data})
        state.ep_id[slot] = ep_ids
        state.insert_slot = (slot + 1) % slots
        state.size = min(state.size + 1, slots)
        return state
