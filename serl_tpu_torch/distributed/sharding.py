"""Data parallelism over torch.distributed ranks: the layout and its collectives.

Port of `serl_tpu/distributed/sharding.py`. The JAX package lays the fused
program over a 1-D `dp` mesh of chips and lets GSPMD insert the
collectives; here every rank is a process on its own `torch.device`, holds
its share of the carry, and calls the collectives itself:

  * envs: rank r of n owns envs [r N/n, (r+1) N/n): their states, obs and
    per-env statistics ("env" rows);
  * replay rings: the same ranks' streams of every (slots, streams, ...)
    ring (axis 1), so an insert stays local and issues no collective; the
    routed ring's per-stream cursors and sizes go with their streams;
  * params, optimizer state and target params are replicated, equal bit for
    bit on every rank: `shard_carry` broadcasts rank 0's, and every
    optimizer step applies gradients averaged over the ranks (one all-reduce
    of one flat buffer per group per step, `TrainState.apply_loss_fns`);
  * demo rings are replicated (small, read-only, sampled by every rank);
  * every random draw is taken at its global shape from the replicated
    generator and cut to the rank's rows, so an n-rank run draws what the
    1-rank run draws, and its generators stay in step.

A sampled batch is stream-major (stream j's R rows contiguous), so a rank
that gathers its own streams holds one contiguous block of the global
batch (the replay buffers' `sample(dp=)`; RLPD's interleave too, its demo
half cut to the same rows), while `update_high_utd` cuts the global batch
into `utd` contiguous minibatches. There, `exchange_minibatches` (one
all-to-all an update) hands rank r rows [k m + r m/n, k m + (r+1) m/n) of
every minibatch k (m = B / utd), in order: the rank's share of each
minibatch, whose local mean loss, averaged over the ranks, is the global
minibatch's. Per-row draws follow their rows (`share_draws`); per-update
draws (`subsample_idx`) are the same everywhere.

Every collective goes through a `DataParallel` handle, which counts calls
and bytes by op (`counts`, the bytes that leave the rank) and the host
seconds they take (`seconds`), at any world size (one rank under NCCL runs
every collective too). The four ops used here (all_reduce, broadcast,
all_gather, all_to_all_single) run on CUDA tensors under both backends
(torch 2.11's gloo included), so nothing is staged through host memory by
hand. With gloo on CUDA tensors each collective waits for the device;
under NCCL it is queued on the stream.

The isolated fwbw program (`training/fwbw.py::make_fwbw_loop`) is laid out
per task: each task's envs and ring streams split as the loop's are, both
agents replicated (`fwbw_carry_layout`, `shard_fwbw_carry`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from serl_tpu_torch.common.train_state import TrainState

# ---------------------------------------------------------------------------
# Declarative per-field layout specs, the JAX package's. Every carry field
# must appear in its spec: a field without a declared layout is a hard error
# (`carry_layout`), never a silent pass-through.
#
# Spec values: "rep" (replicated), "env" (leading env axis split over the
# ranks), "buffer" (the nested ReplayBufferState layout), "routed_buffer"
# (the nested RoutedBufferState layout).
# ---------------------------------------------------------------------------

LOOP_CARRY_SPEC = {
    "agent": "rep",
    "env_states": "env",
    "obs": "env",
    "rb_state": "buffer",
    "demo_state": "rep",  # small, read-only, sampled by every rank
    "rng": "rep",
    "env_steps": "rep",
    "ep_return": "env",
    "ep_count": "rep",
    "ret_sum": "rep",
    "succ_sum": "rep",
    "intervening": "env",  # per-env expert-takeover flag
    "chunk": "env",  # per-env rolling obs history (num_stack > 1)
}

# ReplayBufferState: data rides the (slots, streams) layout with the streams
# split; the cursor and size are host integers, equal on every rank.
BUFFER_STATE_SPEC = {
    "data": "buffer_data",
    "insert_slot": "rep",
    "size": "rep",
    "ep_id": "buffer_data",
}

# TaskCarry and FwBwCarry (training/fwbw.py::make_fwbw_loop): each task
# group's envs and ring split over the ranks, both agents replicated.
TASK_CARRY_SPEC = {
    "agent": "rep",
    "env_states": "env",
    "obs": "env",
    "rb_state": "buffer",
    "demo_state": "rep",
    "ep_return": "env",
    "ep_count": "rep",
    "ret_sum": "rep",
    "succ_sum": "rep",
    "intervening": "env",
}

FWBW_CARRY_SPEC = {
    "fw": "task",
    "bw": "task",
    "rng": "rep",
    "env_steps": "rep",
}

# RoutedBufferState: per-stream cursor and size ride the streams axis, so
# each rank owns its envs' cursors and the masked insert stays local.
ROUTED_BUFFER_STATE_SPEC = {
    "data": "buffer_data",
    "insert_slot": "env",
    "size": "env",
    "ep_id": "buffer_data",
}

# ChainedCarry (training/fwbw.py::make_chained_loop): one chained env batch
# split over the ranks, both agents replicated, both routed rings split along
# their streams, the routed demo rings replicated. `training` (each
# learner's latched gate, a host pair the JAX carry does not have) is
# decided on reduced values, so it is equal on every rank.
CHAINED_CARRY_SPEC = {
    "fw_agent": "rep",
    "bw_agent": "rep",
    "env_states": "env",
    "obs": "env",
    "fw_rb": "routed_buffer",
    "bw_rb": "routed_buffer",
    "fw_demo": "rep",
    "bw_demo": "rep",
    "rng": "rep",
    "env_steps": "rep",
    "ep_return": "env",
    "ep_count": "rep",
    "ret_sum": "rep",
    "succ_sum": "rep",
    "succ_gt_sum": "rep",
    "switch_sum": "rep",
    "intervening": "env",
    "training": "rep",
}


@dataclasses.dataclass(eq=False)
class DataParallel:
    """One rank's view of the data-parallel group.

    counts: op -> {"calls", "bytes"}, bytes that leave this rank (an
    all-reduce's or a broadcast's whole buffer, an all-to-all's rows for
    other ranks, an all-gather's input); seconds: op -> host seconds spent
    in the op's calls."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    counts: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: {"calls": 0, "bytes": 0}))
    seconds: Dict[str, float] = dataclasses.field(default_factory=lambda: defaultdict(float))
    _plans: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------ layout

    def share(self, n: int, what: str = "rows") -> slice:
        """This rank's slice of `n` rows; raises unless n divides evenly."""
        if n % self.world_size != 0:
            raise ValueError(f"{what} {n} must divide evenly over {self.world_size} ranks")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's share of `x` along `dim` (a view)."""
        s = self.share(x.shape[dim], f"axis {dim} of {tuple(x.shape)}")
        return x.narrow(dim, s.start, s.stop - s.start)

    def reset_counts(self) -> None:
        self.counts.clear()
        self.seconds.clear()

    # ------------------------------------------------------------ collectives

    def _run(self, op: str, nbytes: int, fn, tensors: Sequence[torch.Tensor]):
        """Run collective `op` on `tensors`; count it and time it."""
        t0 = time.perf_counter()
        fn(*tensors)
        self.seconds[op] += time.perf_counter() - t0
        self.counts[op]["calls"] += 1
        self.counts[op]["bytes"] += int(nbytes)

    def all_reduce_sum_(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum `buf` over the ranks, in place; returns it."""
        self._run("all_reduce", buf.numel() * buf.element_size(),
                  lambda b: dist.all_reduce(b), [buf])
        return buf

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each of `tensors` (one dtype), through
        one all-reduce of one flat buffer; new tensors, same shapes."""
        tensors = list(tensors)
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise ValueError(f"all_reduce_mean takes one dtype, got {sorted(map(str, dtypes))}")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_sum_(flat).div_(self.world_size)
        return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of `tensors` on every rank, in place: one
        broadcast of one flat buffer per dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = defaultdict(list)
        for t in tensors:
            by_dtype[t.dtype].append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            self._run("broadcast", flat.numel() * flat.element_size(),
                      lambda b: dist.broadcast(b, 0), [flat])
            with torch.no_grad():
                for t, p in zip(group, flat.split([t.numel() for t in group])):
                    t.copy_(p.view(t.shape))

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `x` (same shape on all), by rank."""
        out = [torch.empty_like(x) for _ in range(self.world_size)]
        self._run("all_gather", x.numel() * x.element_size(),
                  lambda *o: dist.all_gather(list(o[:-1]), o[-1]), out + [x])
        return out

    def all_to_all_rows(self, rows: torch.Tensor, send_counts: Sequence[int],
                        recv_counts: Sequence[int]) -> torch.Tensor:
        """One all_to_all_single over the leading axis of `rows`: the first
        send_counts[0] rows to rank 0, the next send_counts[1] to rank 1, ...;
        returns the received rows, ordered by source rank."""
        out = torch.empty((sum(recv_counts),) + tuple(rows.shape[1:]), dtype=rows.dtype,
                          device=rows.device)
        row_bytes = rows[0].numel() * rows.element_size() if rows.shape[0] else 0
        sent = (sum(send_counts) - send_counts[self.rank]) * row_bytes
        self._run("all_to_all", sent,
                  lambda o, i: dist.all_to_all_single(o, i, list(recv_counts), list(send_counts)),
                  [out, rows])
        return out


def num_ranks(dp: Optional[DataParallel]) -> int:
    """The number of ranks: 1 without data parallelism."""
    return 1 if dp is None else dp.world_size


def local(x: torch.Tensor, dp: Optional[DataParallel], dim: int = 0) -> torch.Tensor:
    """This rank's share of a global draw `x` along `dim`; `x` itself
    without data parallelism."""
    return x if dp is None else dp.local(x, dim)


def init_data_parallel(rank: int, world_size: int, *, backend: str, init_method: str,
                       device, timeout=None) -> DataParallel:
    """Join the process group and return this rank's handle. `device` is the
    rank's torch.device (NCCL: one card per rank; gloo: CPU, or CUDA cards
    that ranks may share); `timeout` (a datetime.timedelta) bounds the
    rendezvous and every collective. A failed rendezvous raises."""
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            **kwargs)
    return DataParallel(rank=rank, world_size=world_size, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Carry layout and placement
# ---------------------------------------------------------------------------


def _check_fields(names, spec, what: str) -> None:
    unknown = set(names) - set(spec)
    if unknown:
        raise ValueError(f"{what} field(s) {sorted(unknown)} have no declared layout: add "
                         "them to the spec in serl_tpu_torch/distributed/sharding.py")


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return []


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return tree


def _layout(carry, spec, dp: DataParallel, rings: Sequence[str]) -> Dict[str, str]:
    """field -> kind, after the checks: every field declared, envs and every
    ring's streams dividing evenly over the ranks."""
    _check_fields(carry._fields, spec, type(carry).__name__)
    n = _leaves(carry.env_states)[0].shape[0]
    if n % dp.world_size != 0:
        raise ValueError(f"num_envs {n} must divide evenly over {dp.world_size} ranks")
    for name in rings:
        ring = getattr(carry, name)
        kind_spec = (ROUTED_BUFFER_STATE_SPEC if spec[name] == "routed_buffer"
                     else BUFFER_STATE_SPEC)
        _check_fields([f.name for f in dataclasses.fields(ring)], kind_spec,
                      type(ring).__name__)
        streams = ring.ep_id.shape[1]
        if streams % dp.world_size != 0:
            raise ValueError(f"buffer streams {streams} must divide evenly over "
                             f"{dp.world_size} ranks")
    return {name: spec[name] for name in carry._fields}


def carry_layout(carry, dp: DataParallel) -> Dict[str, str]:
    """A LoopCarry's layout, field by field (`carry_shardings`' counterpart):
    raises on an undeclared field or on envs or streams that do not divide."""
    return _layout(carry, LOOP_CARRY_SPEC, dp, ("rb_state",))


def chained_carry_layout(carry, dp: DataParallel) -> Dict[str, str]:
    """A ChainedCarry's layout (`chained_carry_shardings`' counterpart)."""
    return _layout(carry, CHAINED_CARRY_SPEC, dp, ("fw_rb", "bw_rb"))


def fwbw_carry_layout(carry, dp: DataParallel) -> Dict[str, Any]:
    """A FwBwCarry's layout (`fwbw_carry_shardings`' counterpart): each
    task's TaskCarry layout under its name, the rest by FWBW_CARRY_SPEC;
    raises on an undeclared field or on a task whose envs or streams do not
    divide over the ranks."""
    _check_fields(carry._fields, FWBW_CARRY_SPEC, type(carry).__name__)
    return {name: (_layout(getattr(carry, name), TASK_CARRY_SPEC, dp, ("rb_state",))
                   if FWBW_CARRY_SPEC[name] == "task" else FWBW_CARRY_SPEC[name])
            for name in carry._fields}


def _shard_ring(ring, spec, dp: DataParallel):
    out = {}
    for f in dataclasses.fields(ring):
        value = getattr(ring, f.name)
        kind = spec[f.name]
        if kind == "buffer_data":  # (slots, streams, ...): the rank's streams, contiguous for K4
            out[f.name] = _map(lambda x: dp.local(x, 1).contiguous(), value)
        elif kind == "env":
            out[f.name] = dp.local(value).clone()
        else:
            out[f.name] = value
    return type(ring)(**out)


def agent_tensors(agent) -> List[torch.Tensor]:
    """Every tensor of an agent's replicated learner state: params (by
    group), target params, Adam's moments, and the module's buffers."""
    st = agent.state
    out = [p for g in sorted(st.params) for p in st.params[g]]
    out += [p for g in sorted(st.target_params) for p in st.target_params[g]]
    for g in sorted(st.opt_states):
        out += list(st.opt_states[g].mu) + list(st.opt_states[g].nu)
    return out + list(agent.buffers())


def replicate_agent(agent, dp: DataParallel) -> None:
    """Rank 0's learner state on every rank (one broadcast per dtype), and
    the handle set on the agent's TrainState, whose optimizer steps then
    average each group's gradients over the ranks."""
    dp.broadcast_(agent_tensors(agent))
    agent.state.dp = dp


def _shard(carry, layout: Dict[str, str], dp: DataParallel):
    out = {}
    for name, kind in layout.items():
        value = getattr(carry, name)
        if value is None:
            out[name] = None
        elif kind == "env":
            out[name] = _map(lambda x: dp.local(x).clone(), value)
        elif kind == "buffer":
            out[name] = _shard_ring(value, BUFFER_STATE_SPEC, dp)
        elif kind == "routed_buffer":
            out[name] = _shard_ring(value, ROUTED_BUFFER_STATE_SPEC, dp)
        else:
            if isinstance(getattr(value, "state", None), TrainState):  # an agent
                replicate_agent(value, dp)
            out[name] = value
    return type(carry)(**out)


def shard_carry(carry, dp: DataParallel):
    """This rank's share of a LoopCarry that `init_fn` built at the global
    size: its env rows and ring streams; the agent's state broadcast from
    rank 0 and averaged over the ranks from then on."""
    return _shard(carry, carry_layout(carry, dp), dp)


def shard_chained_carry(carry, dp: DataParallel):
    """This rank's share of a ChainedCarry built at the global size (both
    agents replicated, both routed rings and their cursors split)."""
    return _shard(carry, chained_carry_layout(carry, dp), dp)


def shard_fwbw_carry(carry, dp: DataParallel):
    """This rank's share of a FwBwCarry built at the global size: each
    task's env rows and ring streams, both agents replicated."""
    out = {}
    for name, kind in fwbw_carry_layout(carry, dp).items():
        value = getattr(carry, name)
        out[name] = _shard(value, kind, dp) if isinstance(kind, dict) else value
    return type(carry)(**out)


def replicated_digests(dp: DataParallel, agents: Sequence, generator=None) -> List[str]:
    """Each rank's sha256 over the agents' learner state (`agent_tensors`,
    their host step counts) and the generator's state, gathered by one
    all_gather: equal strings on every rank when the state is replicated."""
    h = hashlib.sha256()
    for agent in agents:
        h.update(np.asarray([agent.state.step] + [o.count for _, o in
                                                  sorted(agent.state.opt_states.items())],
                            np.int64).tobytes())
        for t in agent_tensors(agent):
            h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    if generator is not None:
        h.update(generator.get_state().numpy().tobytes())
    mine = torch.tensor(list(h.digest()), dtype=torch.uint8, device=dp.device)
    return [bytes(d.cpu().tolist()).hex() for d in dp.all_gather(mine)]


# ---------------------------------------------------------------------------
# Rows: the minibatch exchange and the draws that follow their rows
# ---------------------------------------------------------------------------


def minibatch_rows(batch_size: int, minibatches: int, dp: DataParallel) -> torch.Tensor:
    """The global rows this rank holds after the exchange, in order: rows
    [k m + r q, k m + (r+1) q) of every minibatch k (m = batch / minibatches,
    q = m / n), on the rank's device."""
    key = ("rows", batch_size, minibatches)
    if key not in dp._plans:
        m = _minibatch(batch_size, minibatches)
        dp.share(m, "minibatch rows")  # raises unless a minibatch divides over the ranks
        q = m // dp.world_size
        rows = (torch.arange(minibatches, device=dp.device)[:, None] * m + dp.rank * q
                + torch.arange(q, device=dp.device)[None, :])
        dp._plans[key] = rows.reshape(-1)
    return dp._plans[key]


def _minibatch(batch_size: int, minibatches: int) -> int:
    if batch_size % minibatches != 0:
        raise ValueError(f"batch size {batch_size} does not divide by {minibatches} minibatches")
    return batch_size // minibatches


def _exchange_plan(batch_size: int, minibatches: int, dp: DataParallel):
    """(order of the held rows by destination rank, rows sent to each rank,
    rows received from each rank) for `exchange_minibatches`; host counts
    from numpy, the order on the device."""
    key = ("exchange", batch_size, minibatches)
    if key not in dp._plans:
        n, r = dp.world_size, dp.rank
        m = _minibatch(batch_size, minibatches)
        dp.share(m, "minibatch rows")  # raises unless a minibatch divides over the ranks
        q, blk = m // n, batch_size // n

        def dest(rows):  # the rank that holds each global row after the exchange
            return (rows % m) // q

        send = np.bincount(dest(np.arange(r * blk, (r + 1) * blk)), minlength=n).tolist()
        recv = [int((dest(np.arange(p * blk, (p + 1) * blk)) == r).sum()) for p in range(n)]
        order = torch.argsort(dest(torch.arange(r * blk, (r + 1) * blk, device=dp.device)),
                              stable=True)
        dp._plans[key] = (order, send, recv)
    return dp._plans[key]


def _flatten_rows(tree, rows: int):
    """(rows, bytes) uint8 view of every leaf of `tree` side by side, and
    what `_unflatten_rows` needs to undo it."""
    leaves, specs = [], []

    def walk(path, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(path + (k,), v)
            return
        if x.shape[0] != rows:
            raise ValueError(f"batch{list(path)} has {x.shape[0]} rows, want {rows}")
        b = x.contiguous().reshape(rows, -1).view(torch.uint8)
        leaves.append(b)
        specs.append((path, x.dtype, tuple(x.shape[1:]), b.shape[1]))

    walk((), tree)
    return torch.cat(leaves, 1), specs


def _unflatten_rows(flat: torch.Tensor, specs):
    out: Dict = {}
    for (path, dtype, shape, width), part in zip(specs, flat.split([s[3] for s in specs], 1)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = part.contiguous().view(dtype).reshape((flat.shape[0],) + shape)
    return out


def exchange_minibatches(batch: Dict, minibatches: int, dp: DataParallel) -> Dict:
    """The rank's block of a stream-major batch (global rows [r B/n,
    (r+1) B/n), B = n x its rows) -> the rank's share of every one of
    `minibatches` contiguous minibatches of the global batch
    (`minibatch_rows`), through one all_to_all_single of every field's
    bytes side by side (at one rank too: a handle always runs its
    collectives)."""
    rows = _leaves(batch)[0].shape[0]
    batch_size = rows * dp.world_size
    order, send, recv = _exchange_plan(batch_size, minibatches, dp)
    flat, specs = _flatten_rows(batch, rows)
    received = dp.all_to_all_rows(flat.index_select(0, order), send, recv)
    return _unflatten_rows(received, specs)


def take_rows(tree, rows: torch.Tensor, batch_size: int):
    """Rows `rows` of every per-row leaf of `tree`: a leaf of batch_size rows
    directly, one of k x batch_size rows (k blocks of the batch one after
    the other, as an encoder that stacks its cameras along the batch draws
    its dropout masks) block by block."""
    def take(x):
        if x.shape[0] == batch_size:
            return x.index_select(0, rows)
        if x.shape[0] % batch_size != 0:
            raise ValueError(f"a per-row draw of {x.shape[0]} rows for a batch of {batch_size}")
        k = x.shape[0] // batch_size
        return (x.reshape((k, batch_size) + tuple(x.shape[1:])).index_select(1, rows)
                .reshape((k * rows.shape[0],) + tuple(x.shape[1:])))

    return _map(take, tree)


PER_UPDATE_DRAWS = ("subsample_idx",)  # the same on every rank; every other draw is per row


def share_draws(draws: List[Dict], batch_size: int, utd_ratio: int,
                dp: DataParallel) -> List[Dict]:
    """`update_high_utd`'s global draws (one dict per critic minibatch, then
    the actor+temperature update's on the full batch) cut to this rank's
    rows: its share of each minibatch, and of the full batch the union of
    them (`minibatch_rows`)."""
    m = _minibatch(batch_size, utd_ratio)
    mb = dp.share(m, "minibatch rows")
    within = torch.arange(mb.start, mb.stop, device=dp.device)
    full = minibatch_rows(batch_size, utd_ratio, dp)

    def cut(d, rows, n):
        return {k: (v if k in PER_UPDATE_DRAWS else take_rows(v, rows, n)) for k, v in d.items()}

    return [cut(d, within, m) for d in draws[:utd_ratio]] + [cut(draws[utd_ratio], full,
                                                                 batch_size)]
