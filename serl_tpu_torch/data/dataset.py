"""A static dataset of transitions, sampled on its device (offline RL, BC).

Port of `serl_tpu/data/dataset.py`: a dict of arrays (nested dicts too)
moved to one device; `sample_jax`, a batch of rows gathered at uniform
random indices; `split` into two datasets by a permutation; `filter`, the
trajectories (segmented at dones) kept by a return threshold or a top
percentile; `normalize_returns`, the rewards scaled by the spread of the
trajectories' returns. Every draw is explicit (`indices`, `permutation`),
taken from a generator when not given; the tests feed JAX's.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from serl_tpu_torch import resolve_device


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
        """`data` on `device` ("cuda" unless given; a CUDA request without
        CUDA raises)."""
        device = resolve_device(device)
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

    def sample(self, batch_size: int, indx=None,
               generator: Optional[torch.Generator] = None) -> Dict:
        """The rows at `indx` when given, else `sample_jax`'s uniform draw of
        `batch_size` rows from `generator` (JAX's draws from a key)."""
        if indx is None:
            return self.sample_jax(batch_size, generator)
        idx = torch.as_tensor(np.array(indx), dtype=torch.int64, device=self.device)
        return _map(lambda v: v[idx], self.data)

    def split(self, ratio: float, permutation=None) -> Tuple["Dataset", "Dataset"]:
        """The rows at `permutation`'s first int(size * ratio) entries, and
        the rest; `permutation` drawn from numpy's global state unless
        given, as the JAX method draws it."""
        if not 0 < ratio < 1:
            raise ValueError(f"ratio must be in (0, 1), got {ratio}")
        if permutation is None:
            permutation = np.random.permutation(self.size)
        idx = torch.as_tensor(np.asarray(permutation), dtype=torch.int64, device=self.device)
        n = int(self.size * ratio)
        return (Dataset(_map(lambda a: a[idx[:n]], self.data), self.device),
                Dataset(_map(lambda a: a[idx[n:]], self.data), self.device))

    def _trajectory_boundaries_and_returns(self):
        dones = self.data["dones"].cpu().numpy()
        rewards = self.data["rewards"].cpu().numpy()
        starts, ends, returns = [], [], []
        start, ret = 0, 0.0
        for i in range(self.size):
            ret += rewards[i]
            if dones[i] > 0.5:
                starts.append(start)
                ends.append(i + 1)
                returns.append(ret)
                start, ret = i + 1, 0.0
        return starts, ends, returns

    def filter(self, take_top: Optional[float] = None,
               threshold: Optional[float] = None) -> "Dataset":
        """The trajectories whose return is at least `threshold`, or at least
        the (100 - take_top)th percentile of the returns (one of the two)."""
        if (take_top is None) == (threshold is None):
            raise ValueError("give exactly one of take_top and threshold")
        starts, ends, returns = self._trajectory_boundaries_and_returns()
        if take_top is not None:
            threshold = np.percentile(returns, 100 - take_top)
        keep = np.zeros(self.size, bool)
        for s, e, r in zip(starts, ends, returns):
            if r >= threshold:
                keep[s:e] = True
        mask = torch.from_numpy(keep).to(self.device)
        return Dataset(_map(lambda a: a[mask], self.data), self.device)

    def normalize_returns(self, scaling: float = 1000.0) -> "Dataset":
        """Rewards scaled by scaling / (max return - min return), in place."""
        _, _, returns = self._trajectory_boundaries_and_returns()
        spread = max(returns) - min(returns)
        self.data["rewards"] = self.data["rewards"] / float(spread) * scaling
        return self
