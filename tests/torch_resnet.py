"""The frozen ResNet-10's features on the card against the CPU: the rule.

On the card the port runs the frozen backbone's fp32 convolutions on cuDNN's
TF32 path (serl_tpu_torch/vision/encoders.py::_tf32_convs): each product
takes its operands with 10 of fp32's 23 mantissa bits, and accumulates in
fp32. chip_smoke.py holds the card's features of rendered frames to the
CPU's fp32 features of the same frames, with this rule:
  * the allowance is measured on the same frames, on the CPU: the features
    with every convolution's input and weights rounded to TF32
    (`tf32_features`, round to nearest even) against the plain fp32
    features give the error that TF32 alone makes;
  * the card may differ from the CPU's fp32 features by at most
    FACTOR x that error, in the largest and in the mean absolute
    difference. cuDNN's own rounding of the operands and its summation
    order differ from the emulation's, so the factor leaves room; a wrong
    padding, layout or weight moves features by whole units.
It imports torch and the port only (no JAX), so chip_smoke.py can load it
on a machine without JAX.
"""

import torch

from serl_tpu_torch.vision import encoders

FACTOR = 4.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties to even), as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & ~0x1FFF).view(torch.float32)


class _Tf32Functional:
    """torch.nn.functional with conv2d's inputs and weights rounded to TF32."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def conv2d(x, weight, *args, **kwargs):
        return torch.nn.functional.conv2d(tf32_round(x), tf32_round(weight), *args, **kwargs)


@torch.no_grad()
def tf32_features(backbone, frames: torch.Tensor) -> torch.Tensor:
    """The backbone's features with every convolution taken in TF32 (CPU)."""
    plain = encoders.F
    encoders.F = _Tf32Functional()
    try:
        return backbone(frames)
    finally:
        encoders.F = plain


def judge(card: torch.Tensor, cpu: torch.Tensor, emulated: torch.Tensor):
    """(failures, summary) of the card's features against the CPU's fp32
    ones, the allowance from the CPU's TF32 emulation."""
    err = (card.float().cpu() - cpu).abs()
    allowed = (emulated - cpu).abs()
    summary = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
               "tf32_emulated_max": float(allowed.max()),
               "tf32_emulated_mean": float(allowed.mean()),
               "max_abs_feature": float(cpu.abs().max()), "factor": FACTOR}
    failures = []
    if not bool(torch.isfinite(card).all()):
        failures.append("non-finite features")
    if summary["max_abs_err"] > FACTOR * summary["tf32_emulated_max"]:
        failures.append(f"max abs err {summary['max_abs_err']:.3g} > {FACTOR} x "
                        f"{summary['tf32_emulated_max']:.3g}")
    if summary["mean_abs_err"] > FACTOR * summary["tf32_emulated_mean"]:
        failures.append(f"mean abs err {summary['mean_abs_err']:.3g} > {FACTOR} x "
                        f"{summary['tf32_emulated_mean']:.3g}")
    return failures, summary
