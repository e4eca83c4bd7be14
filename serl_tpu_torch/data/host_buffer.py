"""Host-side (numpy) replay ring and data stores for the two-process mode.

Port of `serl_tpu/data/host_buffer.py` (reference
`serl_launcher/data/replay_buffer.py` and `data/data_store.py`): a
preallocated circular numpy buffer with uniform sampling, its thread-safe
`ReplayBufferDataStore` that the learner's TrainerServer inserts pushed
transitions into, and `populate_data_store`, which reads demo pickles. The
storage stays numpy on the host, as in JAX: `sample` draws
`rng.integers(0, size, batch)` from the caller's `np.random.Generator` (JAX's
iterator draws from an unseeded one; here the rng is always the caller's),
so for equal seeds the indices are JAX's. Tensors come only out of
`get_iterator` and `HostToDevice`, which copy numpy batches to the device
through pinned host buffers.

Used only by the two-process examples (`examples/async_*.py`); the fused
mode keeps its ring on the device (`data/replay_buffer.py`).
"""

import collections
import pickle
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from serl_tpu_torch import resolve_device


def map_tree(fn, *trees):
    """fn over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves in sorted key order (jax.tree.leaves' order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class HostToDevice:
    """Copies numpy batches to `device` as tensors. On a CUDA device each
    batch goes through pinned host buffers and `non_blocking` copies; a slot's
    buffers are reused only after the event recorded behind its copies has
    completed, so a copy never reads a buffer that a later batch overwrote.
    On the CPU the tensors share the numpy arrays' memory."""

    def __init__(self, device, slots: int = 2):
        self.device = resolve_device(device)
        self._pinned = [None] * slots
        self._events = [None] * slots
        self._next = 0
        self._started = None

    def __call__(self, batch: Dict) -> Dict:
        if self.device.type != "cuda":
            return map_tree(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device), batch)
        slot = self._next
        self._next = (slot + 1) % len(self._pinned)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        pinned = self._pinned[slot]
        if pinned is None or any(p.shape != a.shape or p.numpy().dtype != a.dtype
                                 for p, a in zip(tree_leaves(pinned), tree_leaves(batch))):
            pinned = self._pinned[slot] = map_tree(
                lambda a: torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True),
                batch)
        map_tree(lambda p, a: np.copyto(p.numpy(), a), pinned, batch)
        self._started = torch.cuda.Event(enable_timing=True)
        self._started.record()
        out = map_tree(lambda p: p.to(self.device, non_blocking=True), pinned)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self._events[slot] = event
        return out

    def last_copy_ms(self) -> float:
        """The device time of the last batch's host-to-device copies (waits
        for them)."""
        done = self._events[(self._next - 1) % len(self._events)]
        done.synchronize()
        return self._started.elapsed_time(done)


def _init_storage(example, capacity: int):
    return map_tree(lambda x: np.zeros((capacity,) + np.shape(x), dtype=np.asarray(x).dtype),
                example)


class HostReplayBuffer:
    """Preallocated circular numpy buffer with uniform sampling."""

    def __init__(self, example_transition: Dict, capacity: int):
        self.capacity = capacity
        self._storage = _init_storage(example_transition, capacity)
        self._insert_index = 0
        self._size = 0

    def insert(self, transition: Dict):
        i = self._insert_index
        map_tree(lambda buf, x: buf.__setitem__(i, x), self._storage, transition)
        self._insert_index = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int, rng: np.random.Generator):
        idx = rng.integers(0, max(self._size, 1), size=batch_size)
        return map_tree(lambda buf: buf[idx], self._storage)

    def get_iterator(self, batch_size: int, device, prefetch: int = 2, *,
                     rng: np.random.Generator) -> Iterator:
        """Batches of tensors on `device`, `prefetch` of them copied ahead
        (reference replay_buffer.py:77-90)."""
        to_device = HostToDevice(device, slots=prefetch + 1)
        queue = collections.deque(to_device(self.sample(batch_size, rng))
                                  for _ in range(prefetch))
        while True:
            if not queue:
                queue.append(to_device(self.sample(batch_size, rng)))
            yield queue.popleft()
            queue.append(to_device(self.sample(batch_size, rng)))

    def download(self, from_idx: int = 0):
        """Chunked export for replication (reference :92-103)."""
        return from_idx, map_tree(lambda buf: buf[from_idx:self._size], self._storage)

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"storage": map_tree(lambda b: b[: self._size], self._storage),
                         "size": self._size}, f)

    def __len__(self):
        return self._size


class ReplayBufferDataStore(HostReplayBuffer):
    """Thread-safe buffer implementing the server-side DataStore protocol:
    inserts under a lock with a monotonically increasing id (reference
    data_store.py:26-80). `rlds_logger`, if given, is any object with
    `log_transition(transition)`, such as `data/trajectory_log.py::
    TrajectoryLogger`; `data/rlds.py::populate_from_rlds` preloads a store
    from an RLDS file."""

    def __init__(self, example_transition: Dict, capacity: int, rlds_logger=None):
        super().__init__(example_transition, capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._logger = rlds_logger

    def insert(self, transition: Dict):
        with self._lock:
            super().insert(transition)
            self._seq += 1
            if self._logger is not None:
                self._logger.log_transition(transition)

    def sample(self, batch_size: int, rng: np.random.Generator):
        with self._lock:
            return super().sample(batch_size, rng)

    def latest_data_id(self) -> int:
        return self._seq

    def get_latest_data(self, from_id: int):
        with self._lock:
            start = max(0, self._size - (self._seq - from_id))
            return self._seq, map_tree(lambda buf: buf[start: self._size], self._storage)


def populate_data_store(store, pkl_path: str) -> int:
    """Insert the demo transitions of a pickle into `store`: a list of
    transition dicts (the reference's format, data_store.py:147-163) or a
    dict of stacked arrays (`data/demos.py::save_demos`' format, whose
    ep_ids and success are dropped). Returns how many. Unpickling runs
    code: load only files this project wrote."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, list):
        for tr in data:
            store.insert(tr)
        return len(data)
    data = dict(data)
    data.pop("ep_ids", None)
    data.pop("success", None)
    count = len(tree_leaves(data)[0])
    for i in range(count):
        store.insert(map_tree(lambda x: x[i], data))
    return count
