"""The ring's seed-made rows: what fills it to capacity before the window.

A deployment that has run for a while samples a full ring. Set-up writes
these rows through the ring's own `load_transitions` after the loop's
random-action steps, leaving room for the steps up to the checked calls, so
that the ring is full when they sample and every later insert overwrites the
oldest row. The rows are drawn on the card from the seed, `CHUNK` slots at a
time, each chunk from a generator of its own, so that the check can draw any
chunk again and compare the rows that the checked calls sampled from it.

Each stream holds episodes of the env's length: ids from `EP0` up, the last
step of each done (mask 0). Images are uniform bytes, the state normal,
actions uniform in [-1, 1], rewards uniform in [0, 1].
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

CHUNK = 64  # slots a chunk
EP0 = 1 << 30  # the first episode id of the seed-made rows, above any the loop gives


class Fill(NamedTuple):
    seed: int
    first: int  # the first slot written
    slots: int  # slots written
    streams: int
    episode: int  # steps an episode


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _put(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def chunk(fill: Fill, c: int, shapes, device) -> Dict:
    """Chunk `c`'s rows, slot-major ((slots * streams, ...) leaves, as
    `load_transitions` takes them, with "ep_ids"); `shapes` is the ring's
    data tree, from which each leaf's row shape and dtype are read."""
    from benchmark.cell import sub_seed

    lo = fill.first + c * CHUNK
    hi = min(lo + CHUNK, fill.first + fill.slots)
    slot = torch.arange(lo, hi, device=device)[:, None].expand(hi - lo, fill.streams)
    stream = torch.arange(fill.streams, device=device)[None, :].expand_as(slot)
    n = slot.numel()
    g = torch.Generator(device=device).manual_seed(sub_seed(fill.seed, f"fill.{c}"))
    dones = (slot % fill.episode == fill.episode - 1).to(torch.float32).reshape(n)
    out: Dict = {"ep_ids": (EP0 + (slot // fill.episode) * fill.streams + stream)
                 .to(torch.int32).reshape(n)}
    for path, leaf in _leaves(shapes):
        shape = (n,) + tuple(leaf.shape[2:])
        if path[-1] == "dones":
            v = dones
        elif path[-1] == "masks":
            v = 1.0 - dones
        elif leaf.dtype == torch.uint8:
            v = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
        elif path[-1] == "actions":
            v = torch.rand(shape, generator=g, device=device) * 2.0 - 1.0
        elif path[-1] == "rewards":
            v = torch.rand(shape, generator=g, device=device)
        else:
            v = torch.randn(shape, generator=g, device=device)
        _put(out, path, v.to(leaf.dtype))
    return out


def chunks(fill: Fill) -> range:
    return range(-(-fill.slots // CHUNK))


def write(rb, state, fill: Fill) -> None:
    """Write the seed-made rows into the program's ring state, chunk by chunk."""
    if state.insert_slot != fill.first:
        raise RuntimeError(f"the ring's cursor is at {state.insert_slot}, not {fill.first}")
    for c in chunks(fill):
        rb.load_transitions(state, chunk(fill, c, state.data, state.ep_id.device))


def rows(fill: Fill, wanted: Dict[int, List[int]], shapes, device) -> Iterator[Tuple[int, int, Dict]]:
    """Draw again the chunks that hold the `wanted` rows ({slot: [stream,
    ...]}); yields (slot, stream, the row's leaves on the CPU)."""
    by_chunk: Dict[int, List[int]] = {}
    for s in wanted:
        by_chunk.setdefault((s - fill.first) // CHUNK, []).append(s)
    for c, slots in sorted(by_chunk.items()):
        data = chunk(fill, c, shapes, device)
        lo = fill.first + c * CHUNK
        for s in slots:
            for e in wanted[s]:
                i = (s - lo) * fill.streams + e
                yield s, e, _index(data, i)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i].cpu()
