"""A static dataset of transitions, sampled on its device (offline RL, BC).

Port of `Dataset(data)` and `sample_jax` from `serl_tpu/data/dataset.py`:
a dict of arrays (nested dicts too) moved to one device, and a batch of rows
gathered at uniform random indices. The indices are an explicit draw
(`indices`), taken from a `torch.Generator` when not given; the tests feed
JAX's. (`split`, `filter` and `normalize_returns` are not ported yet.)
"""

from typing import Dict, Optional

import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class Dataset:
    def __init__(self, data: Dict, device=None):
        self.data = _map(lambda v: torch.as_tensor(v, device=device), data)
        self.size = len(_first_leaf(self.data))
        self.device = _first_leaf(self.data).device

    def sample_jax(self, batch_size: int, generator: Optional[torch.Generator] = None,
                   indices: Optional[torch.Tensor] = None) -> Dict:
        """`batch_size` rows at uniform indices in [0, size) (`indices` when
        given, else drawn from `generator`, which lives on the data's device)."""
        if indices is None:
            indices = torch.randint(0, self.size, (batch_size,), generator=generator,
                                    device=self.device)
        idx = indices.to(self.device)
        return _map(lambda v: v[idx], self.data)
