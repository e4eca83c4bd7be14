"""Task-routed replay buffer: per-stream rings with a masked insert.

Port of `serl_tpu/data/routed_buffer.py`. The chained fwbw workload (E6)
runs one batch of envs whose active task flips at success; each env's
transition goes to the buffer of the task that owned the step and leaves
the other buffer untouched. So the (slots, streams) ring of `ReplayBuffer`
gets a cursor and a size per stream, as (streams,) device tensors, and
`insert` takes a (streams,) mask: a masked-out stream keeps its cursor, its
size and its rows (its cursor row is written back with its own contents,
so a full ring never loses its oldest row). Consecutive writes of one
stream are consecutive steps of one task's episode (tasks flip only at
episode ends), so the successor and frame-stack rules of the parent hold
per stream, and episode ids cover the switch points.

Sampling draws batch / streams rows per stream, uniform over that stream's
own window: offsets u in [0, max(size - sub, 1)) (sub = 1 without stored
next observations), slots (cursor - size + u) % slots, gathered by K4
(`gather_batch_aligned`) unchanged. A stream that was never written samples
its cursor slot (a zero row, ep_id -1), as the reference does; the chained
loop's gate on the total row count lets such rows into early batches.
Neither an insert nor a sample waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from serl_tpu_torch.data.replay_buffer import ReplayBuffer, _map2, gather_batch_aligned


@dataclass
class RoutedBufferState:
    """Like `ReplayBufferState`, with a cursor and a size per stream.
    insert_slot, size: (streams,) int64 tensors on the ring's device."""

    data: Dict[str, torch.Tensor]
    insert_slot: torch.Tensor
    size: torch.Tensor
    ep_id: torch.Tensor  # (slots, streams) int32, -1 = empty


class RoutedReplayBuffer(ReplayBuffer):
    """Masked per-stream ring buffer (see the module docstring)."""

    def init_state(self, streams: int = 1) -> RoutedBufferState:
        state = super().init_state(streams)
        zeros = torch.zeros((int(streams),), dtype=torch.int64, device=self.device)
        return RoutedBufferState(data=state.data, insert_slot=zeros, size=zeros.clone(),
                                 ep_id=state.ep_id)

    def insert(self, state: RoutedBufferState, transitions: Dict, ep_ids: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> RoutedBufferState:
        """Write one row per stream where `mask` ((streams,) bool; None = all
        streams) is set, in place; the other streams are untouched.
        `transitions` leaves are (streams, ...), `ep_ids` (streams,)."""
        tr = dict(transitions)
        if not self.store_next_obs:
            tr.pop("next_observations", None)
        slots, streams = state.ep_id.shape
        idx = state.insert_slot
        cols = torch.arange(streams, device=idx.device)
        if mask is None:
            mask = torch.ones((streams,), dtype=torch.bool, device=idx.device)

        def write(buf, x):
            x = x.to(buf.dtype)
            m = mask.view((streams,) + (1,) * (x.dim() - 1))
            buf[idx, cols] = torch.where(m, x, buf[idx, cols])
            return buf

        _map2(write, state.data, {k: tr[k] for k in state.data})
        state.ep_id[idx, cols] = torch.where(mask, ep_ids.to(torch.int32), state.ep_id[idx, cols])
        state.insert_slot = torch.where(mask, (idx + 1) % slots, idx)
        state.size = torch.where(mask, torch.clamp(state.size + 1, max=slots), state.size)
        return state

    def sample(self, state: RoutedBufferState, batch_size: int, *,
               generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
               e: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """batch_size / streams rows per stream over each stream's own window
        (see the module docstring), stream-major. `u` ((R, streams) int
        offsets, each below its stream's max(size - sub, 1)) is drawn from
        `generator` unless given, as floor(uniform * n_valid) as the JAX
        package draws it; `e` is unused (every sample is stream-aligned)."""
        if self.image_keys and self.store_next_obs:
            raise NotImplementedError("image keys with stored next_observations are not ported")
        slots, streams = state.ep_id.shape
        if batch_size % streams != 0:
            raise ValueError(f"RoutedReplayBuffer needs batch_size ({batch_size}) divisible by "
                             f"the streams ({streams})")
        rows = batch_size // streams
        n_valid = torch.clamp(state.size - (0 if self.store_next_obs else 1), min=1)
        if u is None:
            uniform = torch.rand((rows, streams), generator=generator, device=n_valid.device)
            u = torch.floor(uniform * n_valid.to(torch.float32)).to(torch.int64)
        s2 = ((state.insert_slot - state.size + u.to(n_valid.device)) % slots).contiguous()
        return gather_batch_aligned(state.data, state.ep_id, s2, self.store_next_obs,
                                    self.image_keys, self.num_stack)

