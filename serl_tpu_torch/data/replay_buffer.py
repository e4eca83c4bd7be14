"""Device-resident circular replay buffer: layout, insert and sampling.

Port of `serl_tpu/data/replay_buffer.py`. The layout is the same: every
array is (slots, streams, ...), where `streams` is the number of lockstep
envs and `slots` the per-stream ring length; an insert writes one full slot
at the ring cursor, and `ep_id` records each row's episode so successors and
frame stacks stop at episode boundaries. Observations may be flat or a dict
(the pixel path: {"state": (7,) fp32, "<image key>": (H, W, 3) uint8}).
Unlike the JAX package's pure functions, `insert` writes the state's tensors
in place and returns the same state. The cursor and size are host integers,
so neither an insert nor a sample waits for the device.

`sample` is the JAX package's: stream-aligned when the batch divides over
the streams (exactly batch/streams uniform rows per stream, gathered by K4,
`gather_batch_aligned`), uniform over (slot, stream) pairs otherwise (plain
torch). Without stored next_observations the newest slot is not sampled and
a row's successor falls back to the row itself across an episode boundary.
Sampled image keys always carry a frame-stack axis T = `num_stack`, even at
T = 1 ((B, T, H, W, C)); the "state" key does not. A stack holds slots
s - (T - 1) .. s of the same stream, each frame from another episode
replaced by the stack's first frame of the anchor's episode.

K4 sits beside its plain version: `gather_batch_aligned_plain` (CPU tensors;
on the card only tests and chip_smoke.py call it) and the CUDA kernel in
`serl_tpu_torch/csrc/replay_gather.cu`, which `gather_batch_aligned`
launches for CUDA tensors (one launch for every field of obs and next_obs),
counting its launches in `gather_batch_aligned.launches`.

The demo path: `init_from_episodes` turns episode-major transitions into a
full, write-once ring with one stream per episode; `sample_mixed` draws
RLPD's half-demo batches with the two halves' rows interleaved;
`load_transitions` preloads rows into an existing ring.

A ring that stores next_observations with image keys keeps the JAX
package's quirk: a sample's next_observations take the stored "state" but
their cameras are the observations ring's frame stack at the row's own
slot (the stored next frames are never read), in both samplers and in K4.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.distributed.sharding import local, num_ranks
from serl_tpu_torch.utils.timer import span


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
        num_stack: int = 1,
        device=None,
    ):
        self.capacity = int(capacity)
        self.store_next_obs = bool(store_next_obs)
        self.image_keys = tuple(image_keys)
        self.num_stack = int(num_stack)
        if self.num_stack < 1:
            raise ValueError(f"num_stack must be >= 1, got {num_stack}")
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

    def init_from_episodes(self, transitions: Dict, ep_ids, episode_len: int) -> ReplayBufferState:
        """A full, write-once state from flat episode-major transitions (demo
        ingestion): each of the n / episode_len episodes becomes one stream,
        size = episode_len, insert_slot = 0. Leaves are (n, ...) tensors or
        numpy arrays."""
        tr = dict(transitions)
        if not self.store_next_obs:
            tr.pop("next_observations", None)
        ep_ids = torch.as_tensor(ep_ids)
        n = ep_ids.shape[0]
        if n % episode_len != 0:
            raise ValueError(f"{n} transitions do not divide into episodes of {episode_len}")
        episodes = n // episode_len

        def fold(x, spec):
            """(n, ...) -> (episode_len, episodes, ...), in the example leaf's dtype."""
            if isinstance(x, dict):
                return {k: fold(v, None if spec is None else spec.get(k)) for k, v in x.items()}
            x = torch.as_tensor(x).to(self.device, None if spec is None else spec.dtype)
            # .contiguous(): K4 gathers from contiguous (slots, streams, ...) fields
            return x.reshape((episodes, episode_len) + tuple(x.shape[1:])).transpose(0, 1).contiguous()

        return ReplayBufferState(
            data=fold(tr, self._example),
            insert_slot=0,
            size=int(episode_len),
            ep_id=fold(ep_ids, torch.zeros((), dtype=torch.int32)),
        )

    def insert(self, state: ReplayBufferState, transitions: Dict,
               ep_ids: torch.Tensor) -> ReplayBufferState:
        """Write one lockstep slot in place: `transitions` leaves are
        (streams, ...); `ep_ids` (streams,) episode identifiers (e.g.
        env_index + episode_count * num_envs)."""
        with span("replay.insert"):
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

    # ------------------------------------------------------------------ #

    def sample(self, state: ReplayBufferState, batch_size: int, *,
               generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
               e: Optional[torch.Tensor] = None, dp=None) -> Dict[str, torch.Tensor]:
        """A uniform batch of `batch_size` transitions. The slot offsets `u`
        ((R, streams) when aligned, (batch,) otherwise) and the unaligned
        stream indices `e` are drawn from `generator` unless given.

        Under data parallelism (`dp`, a `distributed.sharding.DataParallel`)
        `state` holds the rank's streams of the ring and `batch_size` is the
        global batch, which must divide over all ranks' streams: `u` is
        drawn (or given) at its global shape and the rank gathers its own
        columns through K4, its block of the global stream-major batch."""
        with span("replay.sample"):
            slots, streams = state.ep_id.shape
            if dp is not None or batch_size % streams == 0:
                return self._sample_aligned(state, batch_size, generator, u, dp)
            n_valid = max(state.size if self.store_next_obs else state.size - 1, 1)
            device = state.ep_id.device
            if u is None:
                u = torch.randint(0, n_valid, (batch_size,), generator=generator, device=device)
            if e is None:
                e = torch.randint(0, streams, (batch_size,), generator=generator, device=device)
            # the valid window is the `size` newest slots ending at insert_slot - 1
            s = (state.insert_slot - state.size + u) % slots
            out = _map(lambda v: v[s, e], state.data)
            if not self.store_next_obs:
                nxt = (s + 1) % slots
                same_ep = state.ep_id[nxt, e] == state.ep_id[s, e]
                safe_nxt = torch.where(same_ep, nxt, s)
                out["next_observations"] = _map(lambda v: v[safe_nxt, e],
                                                state.data["observations"])
                if isinstance(out["next_observations"], dict):
                    out["next_observations"].update(self._stack_obs(state, safe_nxt, e))
            elif isinstance(out["next_observations"], dict):
                # the quirk: stacks from the observations ring at the row itself
                out["next_observations"].update(self._stack_obs(state, s, e))
            if isinstance(out["observations"], dict):
                out["observations"].update(self._stack_obs(state, s, e))
            return out

    def sample_mixed(self, state_a: ReplayBufferState, state_b: ReplayBufferState,
                     batch_size: int, *, generator: Optional[torch.Generator] = None,
                     buffer_b: Optional["ReplayBuffer"] = None,
                     u_a: Optional[torch.Tensor] = None, e_a: Optional[torch.Tensor] = None,
                     u_b: Optional[torch.Tensor] = None,
                     e_b: Optional[torch.Tensor] = None, dp=None) -> Dict[str, torch.Tensor]:
        """RLPD's 50/50 batch: batch_size // 2 rows from `state_a` (this
        buffer), the rest from `state_b` (of `buffer_b`, this buffer unless
        given), each half drawn as `sample` draws it (`u_a`, `e_a`, `u_b`,
        `e_b` are each half's `u` and `e`). For an even batch the rows are
        interleaved, a0, b0, a1, b1, ..., so that every contiguous minibatch
        `update_high_utd` cuts from it is itself half and half; an odd batch
        is the two halves concatenated.

        Under data parallelism (`dp`) `state_a` holds the rank's streams and
        `state_b`, a demo ring, is replicated: the rank's block of the online
        half interleaved with the same rows of the demo half is its block of
        the global interleave."""
        with span("replay.sample"):  # its two samples inside open none
            buffer_b = buffer_b or self
            half = batch_size // 2
            if dp is not None and batch_size % 2 != 0:
                raise ValueError(f"under data parallelism the mixed batch ({batch_size}) must be "
                                 "even")
            a = self.sample(state_a, half, generator=generator, u=u_a, e=e_a, dp=dp)
            b = buffer_b.sample(state_b, batch_size - half, generator=generator, u=u_b, e=e_b)
            if batch_size % 2 == 0:
                return _map2(lambda x, y: torch.stack([x, local(y, dp)], 1).reshape(
                    (2 * x.shape[0],) + tuple(x.shape[1:])), a, b)
            return _map2(lambda x, y: torch.cat([x, y], 0), a, b)

    def _sample_aligned(self, state: ReplayBufferState, batch_size: int, generator, u,
                        dp) -> Dict:
        """The stream-aligned batch, stream-major, or under data parallelism
        the rank's block of the global one: `u` drawn (or given) at the
        global (R, all ranks' streams) shape, the rank's columns gathered
        through K4."""
        slots, streams = state.ep_id.shape
        total = streams * num_ranks(dp)
        if batch_size % total != 0:
            raise ValueError(f"the stream-aligned batch ({batch_size}) must divide over the "
                             f"ring's {total} streams")
        if u is None:
            n_valid = max(state.size if self.store_next_obs else state.size - 1, 1)
            u = torch.randint(0, n_valid, (batch_size // total, total), generator=generator,
                              device=state.ep_id.device)
        s2 = ((state.insert_slot - state.size + local(u, dp, 1)) % slots).contiguous()
        return gather_batch_aligned(state.data, state.ep_id, s2, self.store_next_obs,
                                    self.image_keys, self.num_stack)

    def load_transitions(self, state: ReplayBufferState, transitions: Dict) -> ReplayBufferState:
        """Preload into an existing state: `transitions` holds (n, ...)
        leaves and (n,) `ep_ids`, inserted slot by slot in groups of
        `streams` rows (n must divide by the stream count)."""
        tr = dict(transitions)
        ep_ids = torch.as_tensor(tr.pop("ep_ids"))
        streams = state.ep_id.shape[1]
        n = ep_ids.shape[0]
        if n % streams != 0:
            raise ValueError(f"{n} transitions do not divide over {streams} streams")
        tr = _map(torch.as_tensor, tr)
        for i in range(n // streams):
            rows = slice(i * streams, (i + 1) * streams)
            self.insert(state, _map(lambda x: x[rows], tr), ep_ids[rows])
        return state

    def _stack_obs(self, state: ReplayBufferState, s: torch.Tensor, e: torch.Tensor) -> Dict:
        """(B, T, ...) frame stacks of the image keys anchored at rows (s, e)."""
        slots = state.ep_id.shape[0]
        raw = (s[:, None] - torch.arange(self.num_stack - 1, -1, -1, device=s.device)) % slots
        ep = state.ep_id[raw, e[:, None]]
        safe = _clamp_stack(raw, ep, state.ep_id[s, e])
        return {k: state.data["observations"][k][safe, e[:, None]] for k in self.image_keys}


def _clamp_stack(raw: torch.Tensor, ep: torch.Tensor, anchor_ep: torch.Tensor) -> torch.Tensor:
    """Frame slots `raw` (..., T) with each frame of another episode than
    `anchor_ep` (...) replaced by the stack's first frame of the anchor's episode."""
    valid = ep == anchor_ep[..., None]
    first = valid.to(torch.int32).argmax(-1, keepdim=True)  # argmax returns the first maximum
    return torch.where(valid, raw, raw.gather(-1, first))


# ---------------------------------------------------------------- K4


def gather_batch_aligned_plain(data: Dict, ep_id: torch.Tensor, s2: torch.Tensor,
                               store_next_obs: bool, image_keys: Tuple[str, ...] = (),
                               num_stack: int = 1) -> Dict:
    """Rows (s2[r, j], j) of every (slots, streams, ...) field, stream-major:
    out[j * R + r]. Without stored next_observations, next_observations is
    observations at the successor slot, or at s2 across an episode boundary.
    Image keys of dict observations get (rows, T, ...) frame stacks; with
    stored next_observations their image keys are the observations' stacks
    at s2 (the JAX package's quirk)."""
    slots, streams = ep_id.shape
    rows = s2.shape[0] * streams
    cols = torch.arange(streams, device=s2.device)

    def gather(buf, idx):
        return buf[idx, cols].transpose(0, 1).reshape((rows,) + tuple(buf.shape[2:]))

    def stack(anchor):
        raw = (anchor[:, :, None] - torch.arange(num_stack - 1, -1, -1, device=s2.device)) % slots
        safe = _clamp_stack(raw, ep_id[raw, cols[None, :, None]], ep_id[anchor, cols])
        return {k: torch.stack([gather(data["observations"][k], safe[:, :, t])
                                for t in range(num_stack)], 1) for k in image_keys}

    out = _map(lambda v: gather(v, s2), data)
    if not store_next_obs:
        nxt = (s2 + 1) % slots
        same_ep = ep_id[nxt, cols] == ep_id[s2, cols]
        safe_nxt = torch.where(same_ep, nxt, s2)
        out["next_observations"] = _map(lambda v: gather(v, safe_nxt), data["observations"])
        if isinstance(out["next_observations"], dict):
            out["next_observations"].update(stack(safe_nxt))
    elif isinstance(out["next_observations"], dict):
        out["next_observations"].update(stack(s2))
    if isinstance(out["observations"], dict):
        out["observations"].update(stack(s2))
    return out


@functools.lru_cache(maxsize=None)
def _gather_library():
    """Build (once per source hash) and bind the replay-gather kernel."""
    from serl_tpu_torch.native.build import load_library

    lib = load_library("replay_gather")
    lib.serl_replay_gather.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.serl_replay_gather.restype = ctypes.c_int
    lib.serl_replay_gather_max_fields.argtypes = []
    lib.serl_replay_gather_max_fields.restype = ctypes.c_int
    lib.serl_replay_gather_error_string.argtypes = [ctypes.c_int]
    lib.serl_replay_gather_error_string.restype = ctypes.c_char_p
    return lib


def gather_batch_aligned_cuda(data: Dict, ep_id: torch.Tensor, s2: torch.Tensor,
                              store_next_obs: bool, image_keys: Tuple[str, ...] = (),
                              num_stack: int = 1) -> Dict:
    """`gather_batch_aligned_plain` by the CUDA kernel, in one launch."""
    slots, streams = ep_id.shape
    device = ep_id.device
    if device.type != "cuda":
        raise ValueError(f"gather_batch_aligned_cuda needs CUDA tensors, got {device}")
    if ep_id.dtype != torch.int32 or not ep_id.is_contiguous():
        raise ValueError(f"ep_id: want contiguous int32, got {ep_id.dtype}")
    if (s2.dtype != torch.int64 or s2.device != device or s2.dim() != 2
            or s2.shape[1] != streams or not s2.is_contiguous()):
        raise ValueError(f"s2: want contiguous int64 (R, {streams}) on {device}, got "
                         f"{s2.dtype} {tuple(s2.shape)} on {s2.device}")
    rows = s2.shape[0] * streams
    jobs = []  # (output path, source, successor?, stacked?)

    def add(path, buf, successor):
        if isinstance(buf, dict):
            for k, v in buf.items():
                add(path + (k,), v, successor)
            return
        if buf.device != device or not buf.is_contiguous() or tuple(buf.shape[:2]) != (slots,
                                                                                         streams):
            raise ValueError(f"data{list(path)}: want contiguous ({slots}, {streams}, ...) on "
                             f"{device}, got {tuple(buf.shape)} on {buf.device}")
        stacked = len(path) == 2 and path[1] in image_keys
        jobs.append((path, buf, successor, stacked))

    for k, v in data.items():
        if k == "next_observations" and isinstance(v, dict):
            # the quirk: stored next_observations' cameras are stacked from
            # the observations ring at the row's own slot
            v = {key: data["observations"][key] if key in image_keys else x
                 for key, x in v.items()}
        add((k,), v, 0)
    if not store_next_obs:
        add(("next_observations",), data["observations"], 1)
    lib = _gather_library()
    if len(jobs) > lib.serl_replay_gather_max_fields():
        raise ValueError(f"{len(jobs)} fields, the kernel takes at most "
                         f"{lib.serl_replay_gather_max_fields()}")
    out: Dict = {}
    dsts = []
    for path, buf, _, stacked in jobs:
        shape = (rows,) + ((num_stack,) if stacked else ()) + tuple(buf.shape[2:])
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(shape, dtype=buf.dtype, device=device)
        dsts.append(node[path[-1]])
    n = len(jobs)
    src = (ctypes.c_void_p * n)(*(buf.data_ptr() for _, buf, _, _ in jobs))
    dst = (ctypes.c_void_p * n)(*(t.data_ptr() for t in dsts))
    row_bytes = (ctypes.c_int64 * n)(*(buf[0, 0].numel() * buf.element_size()
                                       for _, buf, _, _ in jobs))
    successor = (ctypes.c_int * n)(*(flag for _, _, flag, _ in jobs))
    stacked = (ctypes.c_int * n)(*(int(flag) for _, _, _, flag in jobs))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.serl_replay_gather(src, dst, row_bytes, successor, stacked, n, int(num_stack),
                                    s2.data_ptr(), ep_id.data_ptr(), slots, streams, s2.shape[0],
                                    stream)
    if rc != 0:
        raise RuntimeError(
            f"replay gather kernel launch failed: {lib.serl_replay_gather_error_string(rc).decode()}")
    gather_batch_aligned.launches += 1
    return out


def gather_batch_aligned(data: Dict, ep_id: torch.Tensor, s2: torch.Tensor, store_next_obs: bool,
                         image_keys: Tuple[str, ...] = (), num_stack: int = 1) -> Dict:
    """K4: the stream-aligned batch gather. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise."""
    if ep_id.device.type == "cpu":
        return gather_batch_aligned_plain(data, ep_id, s2, store_next_obs, image_keys, num_stack)
    return gather_batch_aligned_cuda(data, ep_id, s2, store_next_obs, image_keys, num_stack)


gather_batch_aligned.launches = 0
