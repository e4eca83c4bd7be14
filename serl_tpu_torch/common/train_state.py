"""Multi-group train state for RL agents.

Port of `serl_tpu/common/train_state.py`. Parameters are partitioned into
named groups ("actor", "critic", "temperature"), each a list of the agent's
own parameter tensors with its own optimizer; "critic" also has a polyak
target copy. Unlike the JAX package's pure pytree, the state updates the
tensors in place.

`apply_loss_fns` evaluates every group's loss at the same pre-step params,
differentiates each with `torch.autograd.grad` w.r.t. its own group only
(never `.backward()`, which would also fill the grads of every other group
that a loss passes through), and only then steps all groups.

Data parallelism (`distributed/sharding.py`): with a handle in `dp`, each
rank's losses are local means over its rows, and each group's gradients,
with its loss infos, are averaged over the ranks (one all-reduce of one
flat buffer per group per step) before any group steps. That is the
all-reduce GSPMD inserts in the JAX package (the `pmean_axis` hook of its
train state): the optimizer then steps on equal gradients everywhere, so
params and optimizer state stay equal bit for bit across the ranks. A group
with no loss (None: zero gradients) has nothing to average.

An optimizer step reads its per-step scalars (lr, bias corrections,
computed on the host) from a tensor on the device. `apply_gradients` steps
each group with `Optimizer.step`, which copies them there itself and moves
the group's host state on. Given one tensor of every group's scalars
(`step_scalars`), it runs the device side alone and changes no host state:
a CUDA graph captures such a step once and replays it (agents/graphs.py),
and the replay's caller fills the tensor and then calls `advance` (the
counts, learning rates and `step`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from serl_tpu_torch.common.optimizers import OptState, Optimizer
from serl_tpu_torch.utils.timer import span

# A loss function takes no arguments (it closes over its batch and draws) and
# returns (scalar loss, info dict). None stands for the JAX package's
# zero loss: the group's optimizer steps with zero gradients.
LossFn = Optional[Callable[[], Tuple[torch.Tensor, Dict]]]


class TrainState:
    """step: optimizer applications so far. params: group -> list of the
    agent's parameter tensors. target_params: group -> detached copies.
    opt_states: group -> OptState. txs: group -> Optimizer."""

    def __init__(self, params: Dict[str, List[torch.Tensor]], txs: Dict[str, Optimizer],
                 target_groups: Sequence[str] = ()):
        if not set(txs) <= set(params):
            raise ValueError(f"optimizers {sorted(txs)} for groups {sorted(params)}")
        self.step = 0
        self.params = {g: list(p) for g, p in params.items()}
        self.txs = dict(txs)
        self.opt_states: Dict[str, OptState] = {g: tx.init(self.params[g]) for g, tx in txs.items()}
        self.target_params = {g: [p.detach().clone() for p in self.params[g]] for g in target_groups}
        self.dp = None  # a distributed.sharding.DataParallel: average gradients over its ranks

    @torch.no_grad()
    def target_update(self, tau: float) -> None:
        """target = tau * params + (1 - tau) * target, in place."""
        with span("learner.optimizer"):
            for g, targets in self.target_params.items():
                torch._foreach_mul_(targets, 1.0 - tau)
                torch._foreach_add_(targets, self.params[g], alpha=tau)

    def apply_gradients(self, grads: Dict[str, Optional[List[torch.Tensor]]],
                        scalars: Optional[torch.Tensor] = None) -> None:
        """Step each named group with its own optimizer (None: zero grads).
        Given `scalars` (`step_scalars`' rows on the device, every group
        named) the device side only, which changes no host state."""
        with span("learner.optimizer"):
            if scalars is None:
                for g, grad in grads.items():
                    self.opt_states[g] = self.txs[g].step(self.params[g], grad, self.opt_states[g])
            else:
                if sorted(grads) != sorted(self.txs):
                    raise ValueError(f"a step on given scalars steps every group "
                                     f"{sorted(self.txs)}, not {sorted(grads)}")
                for g, row in zip(sorted(self.txs), scalars):
                    state = self.opt_states[g]
                    self.txs[g].update(self.params[g], grads[g], state.mu, state.nu, row)
        if scalars is None:
            self.step += 1

    def step_scalars(self) -> Dict[str, Tuple[float, float, float]]:
        """`Optimizer.scalars` (lr, bias corrections) of each group's next
        step, the groups in sorted order."""
        return {g: self.txs[g].scalars(self.opt_states[g].count) for g in sorted(self.txs)}

    def advance(self, rows: Dict[str, Tuple]) -> None:
        """The host side of a step on `step_scalars`' `rows`: each group's
        count and learning rate, and `step`."""
        for g, (lr, _, _) in rows.items():
            state = self.opt_states[g]
            self.opt_states[g] = OptState(state.count + 1, state.mu, state.nu, lr)
        self.step += 1

    def apply_loss_fns(self, loss_fns: Dict[str, LossFn],
                       scalars: Optional[torch.Tensor] = None) -> Dict[str, Dict]:
        """Differentiate each loss w.r.t. its own group at the current params,
        then step every group (`scalars` as `apply_gradients`); returns the
        infos by group name."""
        grads: Dict[str, Optional[List[torch.Tensor]]] = {}
        infos: Dict[str, Dict] = {}
        for g in sorted(loss_fns):
            if loss_fns[g] is None:
                grads[g], infos[g] = None, {}
                continue
            with span("learner.forward"):
                loss, info = loss_fns[g]()
            with span("learner.backward"):
                grads[g] = list(torch.autograd.grad(loss, self.params[g], allow_unused=True,
                                                    materialize_grads=True))
            infos[g] = info
            if self.dp is not None:
                keys = [k for k, v in info.items() if isinstance(v, torch.Tensor)]
                mean = self.dp.all_reduce_mean(grads[g] + [info[k] for k in keys])
                grads[g] = mean[:len(grads[g])]
                infos[g] = {**info, **dict(zip(keys, mean[len(grads[g]):]))}
        self.apply_gradients(grads, scalars)
        return infos
