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
host in float32 from host integers (`Optimizer.scalars`), so a step never
waits for the device, and reaches the device in one tensor
(`device_scalars`, copied without waiting from pinned memory on a card),
which `update` reads: a CUDA graph of the step reads it anew at each replay
(agents/graphs.py), and an eager step runs the same kernels. On the CPU this
gives the bits of the host-float arithmetic (`p - lr * u` with lr a Python
float). Params are updated in place.
"""

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

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

    def scalars(self, count: int) -> Tuple[float, float, float]:
        """(lr, bias correction 1, bias correction 2) of the step taken at
        count `count`, in float32 from host integers."""
        n = _F32(count + 1)
        return (self.schedule(count), float(_F32(1) - _F32(B1) ** n),
                float(_F32(1) - _F32(B2) ** n))

    def step(self, params: Sequence[torch.Tensor], grads: Optional[Sequence[torch.Tensor]],
             state: OptState) -> OptState:
        """One optax step of `params` in place; `grads=None` means zeros."""
        params = list(params)
        row = self.scalars(state.count)
        self.update(params, grads, state.mu, state.nu, device_scalars([row], params[0].device)[0])
        return OptState(count=state.count + 1, mu=state.mu, nu=state.nu, learning_rate=row[0])

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Optional[Sequence[torch.Tensor]],
               mu: List[torch.Tensor], nu: List[torch.Tensor], scalars: torch.Tensor) -> None:
        """The device side of a step: params and moments in place, reading
        the step's `scalars` (lr, bias correction 1, bias correction 2) from a
        (3,) float32 tensor on the params' device."""
        params = list(params)
        lr, bc1, bc2 = scalars
        if grads is not None and self.clip_grad_norm is not None:
            grads = _clip_by_global_norm(list(grads), self.clip_grad_norm)
        # (1 - b) * g**k + b * t, as optax.tree.update_moment; a zero g leaves b * t
        torch._foreach_mul_(mu, B1)
        torch._foreach_mul_(nu, B2)
        if grads is not None:
            grads = list(grads)
            torch._foreach_add_(mu, grads, alpha=1.0 - B1)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_addcmul_(params, updates, [lr] * len(params), value=-1.0)


def device_scalars(rows: Sequence[Tuple[float, float, float]], device: torch.device,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`Optimizer.scalars` rows as one (rows, 3) float32 tensor on `device`
    (or copied into `out`); on a card copied from pinned memory without
    waiting (the host allocator keeps the pinned block until the copy is
    done)."""
    host = torch.tensor(rows, dtype=torch.float32, pin_memory=device.type == "cuda")
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


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
