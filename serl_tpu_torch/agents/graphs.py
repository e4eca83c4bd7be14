"""CUDA graphs of `SACAgent.update`: each step captured once, then replayed.

At the learner's sizes the host takes longer to launch an update's ~400-1,200
small kernels from Python than the card takes to run them, so the card waits
on the host. A CUDA graph records a step's kernels once; a replay launches
them all in one call.

What a graph holds is `SACAgent._step` on static copies of the batch and the
draws: every group's loss and gradient, every group's optimizer step and the
target update. What stays in Python, for each step: the draws (made before
`update` reaches here), copying the batch's and the draws' leaves into the
graph's inputs, the optimizer's per-step scalars (computed on the host,
`TrainState.step_scalars`, then one pinned tensor copied into a buffer the
graph reads; an eager step reads them from the device too, so it runs the
kernels a replay runs), the replay, cloning the infos out of the graph's
outputs (the minibatch updates of `update_high_utd` replay one graph, and
each replay overwrites its outputs), and the host state
(`TrainState.advance`: counts, learning rates, `step`).

`UpdateGraphs.run` chooses from what it can observe:
  * a step runs eager unless every leaf of its batch and draws is a CUDA
    tensor, the train state has no data-parallel handle (its all-reduces are
    not captured) and no dispatch mode is active (a FLOP counter or any other
    mode sees each op, and a replay dispatches none);
  * a key's first step runs eager: it sets up what kernels set up at their
    first use (cuBLAS and cuDNN, K5's scratch) outside the graphs' memory.
    Its second step captures, and it and every later step replay. A key is
    the networks updated, the trees' structure and each leaf's shape,
    strides, dtype and device, the agent's config and its optimizers;
  * a graph reads and writes the addresses of the train state's tensors
    (params, Adam moments, targets) and the agent's buffers. A step that finds
    one moved (a restore that swapped tensors) captures anew;
  * a key whose capture raises runs eager from then on: it is warned, and
    kept in `failed` with its error. Later captures take a new memory pool
    and stream.
An agent's graphs share one memory pool: they replay one at a time on one
stream, and a replay's outputs are cloned before the next replay.

K5's wrappers count their launches on the host (`.launches`, `shape_log`,
`flops`). A capture calls them and launches nothing, and a replay launches
the captured kernels without calling them, so the capture's counts are kept
apart and each replay adds them (`dense_layer_norm_tanh.counts_apart`): the
counts are those of the launches that reach the card.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from serl_tpu_torch.common.optimizers import device_scalars
from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from serl_tpu_torch.utils.timer import span


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _signature(tree):
    """The tree's structure, and each leaf's shape, strides, dtype and device."""
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree),) + tuple(_signature(v) for v in tree)
    return (tree.shape, tree.stride(), tree.dtype, tree.device)


def _state_tensors(agent) -> List[torch.Tensor]:
    """The train state's tensors that a step writes in place."""
    state = agent.state
    tensors = [t for group in state.params.values() for t in group]
    for opt_state in state.opt_states.values():
        tensors += opt_state.mu + opt_state.nu
    return tensors + [t for group in state.target_params.values() for t in group]


def _addresses(agent) -> tuple:
    """The addresses a captured step reads and writes in place."""
    return tuple(map(torch.Tensor.data_ptr, _state_tensors(agent) + list(agent.buffers())))


def _clone(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


def _capture(graph, pool, stream, fn: Callable):
    """`fn()` captured into `graph` on `stream`, as `torch.cuda.graph` does,
    and ended where the capture fails: there an invalidated capture's end
    raises before torch stops routing allocations into the pool and before
    it restores the caller's stream. The pool takes no later capture (torch
    2.11), so `UpdateGraphs` moves on to a new one."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            result = fn()
        except BaseException:
            _abandon(graph, pool, stream)
            raise
        try:
            graph.capture_end()
        except RuntimeError:
            _abandon(graph, pool, stream)
            raise
    return result


def _abandon(graph, pool, stream) -> None:
    with contextlib.suppress(RuntimeError):  # the stream stops capturing, whatever it returns
        graph.capture_end()
    with contextlib.suppress(RuntimeError):  # raises where the end got that far
        torch._C._cuda_endAllocateToPool(stream.device.index, pool)


class _Graph:
    """One captured step: its graph, its static inputs and scalars, its outputs."""

    def __init__(self, agent, batch, draws, networks, pool, stream, addresses: tuple):
        inputs = _map(torch.clone, batch), _map(torch.clone, draws)
        self.inputs = _leaves(inputs)
        self.scalars = torch.empty((len(agent.state.txs), 3), device=self.inputs[0].device)
        self.graph = torch.cuda.CUDAGraph()
        self.addresses = addresses
        with span("learner.capture"), k5.counts_apart() as self.counts:
            self.outputs = _capture(self.graph, pool, stream,
                                    lambda: agent._step(*inputs, networks, self.scalars))

    def replay(self, agent, leaves: List[torch.Tensor]) -> Dict:
        rows = agent.state.step_scalars()
        with span("learner.replay"):
            device_scalars(list(rows.values()), self.scalars.device, out=self.scalars)
            torch._foreach_copy_(self.inputs, leaves, non_blocking=True)
            self.graph.replay()
            infos = _map(_clone, self.outputs)
        agent.state.advance(rows)
        self.counts.add()
        return infos


class UpdateGraphs:
    """An agent's captured update steps (see the module docstring)."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.failed: Dict[tuple, str] = {}  # keys whose capture raised: their error
        self.pool = self.stream = None  # made at the first capture
        self.seen: set = set()  # keys whose first step ran eager
        self.captures = 0
        self.replays = 0

    def run(self, agent, batch, draws, networks) -> Optional[Dict]:
        """The infos of `agent._step(batch, draws, networks)` from a replay,
        which has also advanced the train state; None where the caller runs
        the step eager."""
        leaves = _leaves(batch) + _leaves(draws)
        if (agent.state.dp is not None or _get_current_dispatch_mode() is not None
                or not all(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)):
            return None
        key = (networks, _signature(batch), _signature(draws), agent.config,
               tuple(sorted(agent.state.txs.items())))
        if key in self.failed:
            return None
        if key not in self.seen:
            self.seen.add(key)
            return None
        graph, addresses = self.graphs.get(key), _addresses(agent)
        if graph is None or graph.addresses != addresses:
            self.graphs.pop(key, None)  # a stale graph's memory goes back to the pool first
            if self.pool is None:
                self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
            try:
                graph = _Graph(agent, batch, draws, networks, self.pool, self.stream, addresses)
            except Exception as e:  # noqa: BLE001 - a loss that cannot be captured runs eager
                self.failed[key] = f"{type(e).__name__}: {e}"
                # later captures go to a pool and a stream that the failed one left untouched
                self.pool = self.stream = None
                warnings.warn(f"{type(agent).__name__}.update ({sorted(networks)}): the CUDA "
                              f"graph's capture failed, so this step runs eager from now on: "
                              f"{self.failed[key]}", RuntimeWarning, stacklevel=3)
                return None
            self.graphs[key] = graph
            self.captures += 1
        self.replays += 1
        return graph.replay(agent, leaves)
