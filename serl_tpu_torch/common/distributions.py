"""Minimal action distributions (plain PyTorch).

Port of `serl_tpu/common/distributions.py`: a diagonal Normal and the
tanh-squashed TanhNormal that SERL's policies use, with closed-form math.
`sample` takes either explicit standard-normal noise `eps` (the tests feed
the JAX draws that way) or a `torch.Generator`.

Numerical note: log|d tanh(x)/dx| = log(1 - tanh(x)^2) is computed via the
stable identity 2*(log 2 - x - softplus(-2x)) instead of log1p(-tanh(x)^2).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def _noise(like: torch.Tensor, eps: Optional[torch.Tensor], generator) -> torch.Tensor:
    if eps is not None:
        return eps.to(like)
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class Normal:
    """Diagonal Gaussian over the last axis (event dim)."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: Optional[torch.Generator] = None, eps=None) -> torch.Tensor:
        return self.loc + self.scale * _noise(self.loc, eps, generator)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        per_dim = -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)
        return per_dim.sum(-1)

    def sample_and_log_prob(self, generator=None, eps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.sample(generator, eps)
        return x, self.log_prob(x)

    def mode(self) -> torch.Tensor:
        return self.loc

    def stddev(self) -> torch.Tensor:
        return torch.broadcast_to(self.scale, self.loc.shape)

    def entropy(self) -> torch.Tensor:
        per_dim = 0.5 * (1.0 + _LOG_2PI) + torch.log(self.scale)
        return torch.broadcast_to(per_dim, self.loc.shape).sum(-1)


def _tanh_log_det_jacobian(pre_tanh: torch.Tensor) -> torch.Tensor:
    # log(1 - tanh(x)^2) == 2 * (log 2 - x - softplus(-2x)), summed over event dim
    per_dim = 2.0 * (_LOG_2 - pre_tanh - F.softplus(-2.0 * pre_tanh))
    return per_dim.sum(-1)


class TanhNormal:
    """tanh-squashed diagonal Gaussian on (-1, 1), or with bounds `low` and
    `high` mapped affinely onto (low, high): y = (tanh(x) + 1) / 2 * (high -
    low) + low, whose log-det adds sum(log((high - low) / 2)) to the tanh's.
    `mode()` pushes the Gaussian mean through the bijector."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor,
                 low: Optional[torch.Tensor] = None, high: Optional[torch.Tensor] = None):
        self.loc = loc
        self.scale = scale
        self.low = low
        self.high = high

    def _bounded(self) -> bool:
        return self.low is not None and self.high is not None

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.tanh(x)
        if self._bounded():
            y = (y + 1.0) * 0.5 * (self.high - self.low) + self.low
        return y

    def _log_det(self, pre: torch.Tensor) -> torch.Tensor:
        log_det = _tanh_log_det_jacobian(pre)
        if self._bounded():
            scale = torch.log(0.5 * (self.high - self.low))
            log_det = log_det + torch.broadcast_to(scale, pre.shape).sum(-1)
        return log_det

    def sample(self, generator: Optional[torch.Generator] = None, eps=None) -> torch.Tensor:
        return self._forward(self.loc + self.scale * _noise(self.loc, eps, generator))

    def sample_and_log_prob(self, generator=None, eps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        pre = self.loc + self.scale * _noise(self.loc, eps, generator)
        base = Normal(self.loc, self.scale).log_prob(pre)
        return self._forward(pre), base - self._log_det(pre)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Log-density of a squashed sample (inverts the bijector; clipped for
        numerical safety near the boundary)."""
        y = value
        if self._bounded():
            y = (y - self.low) / (0.5 * (self.high - self.low)) - 1.0
        pre = torch.atanh(torch.clamp(y, -1.0 + 1e-6, 1.0 - 1e-6))
        base = Normal(self.loc, self.scale).log_prob(pre)
        return base - self._log_det(pre)

    def mode(self) -> torch.Tensor:
        return self._forward(self.loc)

    def stddev(self) -> torch.Tensor:
        """The bijector's forward of the base std (the JAX package's and the
        reference's meaning), not the std of the squashed variable."""
        return self._forward(torch.broadcast_to(self.scale, self.loc.shape))
