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


def _tanh_log_det_jacobian(pre_tanh: torch.Tensor) -> torch.Tensor:
    # log(1 - tanh(x)^2) == 2 * (log 2 - x - softplus(-2x)), summed over event dim
    per_dim = 2.0 * (_LOG_2 - pre_tanh - F.softplus(-2.0 * pre_tanh))
    return per_dim.sum(-1)


class TanhNormal:
    """tanh-squashed diagonal Gaussian on (-1, 1). `mode()` pushes the
    Gaussian mean through the bijector: tanh(loc). (The JAX class's optional
    [low, high] rescaling has no caller and is not ported.)"""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: Optional[torch.Generator] = None, eps=None) -> torch.Tensor:
        return torch.tanh(self.loc + self.scale * _noise(self.loc, eps, generator))

    def sample_and_log_prob(self, generator=None, eps=None) -> Tuple[torch.Tensor, torch.Tensor]:
        pre = self.loc + self.scale * _noise(self.loc, eps, generator)
        base = Normal(self.loc, self.scale).log_prob(pre)
        return torch.tanh(pre), base - _tanh_log_det_jacobian(pre)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Log-density of a squashed sample (inverts the bijector; clipped for
        numerical safety near the boundary)."""
        pre = torch.atanh(torch.clamp(value, -1.0 + 1e-6, 1.0 - 1e-6))
        base = Normal(self.loc, self.scale).log_prob(pre)
        return base - _tanh_log_det_jacobian(pre)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)
