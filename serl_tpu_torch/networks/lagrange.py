"""Lagrange multipliers (used as the SAC temperature).

Port of `serl_tpu/networks/lagrange.py`: plain functions over a one-entry
param dict {"raw": tensor}, so the temperature stays its own param group.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def init_lagrange_params(
    init_value: float = 1.0,
    constraint_shape: Sequence[int] = (),
    parameterization: str = "softplus",
):
    if not init_value > 0:
        raise ValueError(f"init_value must be positive, got {init_value}")
    if parameterization == "softplus":
        raw = math.log(math.exp(init_value) - 1.0)
    elif parameterization == "exp":
        raw = math.log(init_value)
    else:
        raise ValueError(parameterization)
    return {"raw": torch.full(tuple(constraint_shape), raw, dtype=torch.float32)}


def lagrange_value(params, parameterization: str = "softplus") -> torch.Tensor:
    raw = params["raw"]
    if parameterization == "softplus":
        return F.softplus(raw)
    return torch.exp(raw)


def lagrange_penalty(params, lhs: torch.Tensor, rhs) -> torch.Tensor:
    """multiplier * (lhs - rhs): the penalty of the constraint lhs >= rhs."""
    return lagrange_value(params) * (lhs - rhs)
