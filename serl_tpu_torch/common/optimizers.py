"""Optimizer factory: clip -> Adam -> decayed weights -> -lr(count).

Port of `serl_tpu/common/optimizers.py` as plain functions over lists of
tensors, not `torch.optim`, so that three of optax's behaviours carry over:
  * a step's learning rate is the schedule at the optimizer's own count
    BEFORE the step, so with warmup the first step has lr 0;
  * a step with no gradients (`grads=None`: zero gradients) still decays
    Adam's moments into the params and advances the count, which is what a
    group left out of an SAC update does (torch.optim would skip it);
  * Adam is optax's `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, eps_root 0), bias-corrected by the step count.
Every per-step scalar (learning rate, bias corrections) is computed on the
host in float32 from host integers, so a step never waits for the device.
Params are updated in place.
"""

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

_F32 = np.float32
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults, as the JAX package uses them


@dataclass
class OptState:
    """count: steps taken. optax keeps three counts (Adam's, the schedule's
    and inject_hyperparams'), which always agree; this is all three.
    learning_rate: the lr of the last step (the schedule at 0 before any
    step), which `optimizer_lr` reads."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    learning_rate: float


class Optimizer(NamedTuple):
    learning_rate: float = 3e-4
    warmup_steps: int = 0
    cosine_decay_steps: Optional[int] = None
    weight_decay: Optional[float] = None
    clip_grad_norm: Optional[float] = None

    def schedule(self, count: int) -> float:
        """The learning rate at step count `count`, in float32 like optax's
        schedules (linear warmup from 0, then constant or cosine to 0)."""
        lr, count = _F32(self.learning_rate), _F32(count)
        if self.cosine_decay_steps is not None:
            warmup = self.warmup_steps
            if count < warmup:  # optax.linear_schedule(0, lr, warmup)
                frac = _F32(1) - min(count, _F32(warmup)) / _F32(warmup)
                return float(-lr * frac + lr)
            steps = _F32(self.cosine_decay_steps - warmup)
            c = min(count - _F32(warmup), steps)
            cosine = _F32(0.5) * (_F32(1) + _F32(math.cos(_F32(math.pi) * c / steps)))
            return float(lr * cosine)
        if self.warmup_steps > 0:
            return float(lr * min(count / _F32(self.warmup_steps), _F32(1)))
        return float(lr)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        return OptState(count=0, mu=[torch.zeros_like(p) for p in params],
                        nu=[torch.zeros_like(p) for p in params],
                        learning_rate=self.schedule(0))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Optional[Sequence[torch.Tensor]],
             state: OptState) -> OptState:
        """One optax step of `params` in place; `grads=None` means zeros."""
        params = list(params)
        mu, nu = state.mu, state.nu
        if grads is not None and self.clip_grad_norm is not None:
            grads = _clip_by_global_norm(list(grads), self.clip_grad_norm)
        # (1 - b) * g**k + b * t, as optax.tree.update_moment; a zero g leaves b * t
        torch._foreach_mul_(mu, B1)
        torch._foreach_mul_(nu, B2)
        if grads is not None:
            grads = list(grads)
            torch._foreach_add_(mu, grads, alpha=1.0 - B1)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        count = state.count + 1
        bc1 = float(_F32(1) - _F32(B1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(B2) ** _F32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        lr = self.schedule(state.count)
        torch._foreach_add_(params, updates, alpha=-lr)
        return OptState(count=count, mu=mu, nu=nu, learning_rate=lr)


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g unchanged when the global norm is below
    max_norm, else g / norm * max_norm (decided on the device, no sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def make_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 0,
    cosine_decay_steps: Optional[int] = None,
    weight_decay: Optional[float] = None,
    clip_grad_norm: Optional[float] = None,
) -> Optimizer:
    return Optimizer(learning_rate, warmup_steps, cosine_decay_steps, weight_decay, clip_grad_norm)


def optimizer_lr(opt_state: OptState) -> float:
    """The learning rate of the state's last step."""
    return opt_state.learning_rate
