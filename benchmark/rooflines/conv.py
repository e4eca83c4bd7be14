"""The convolutions' roofline: the counted work of the encoders' convolutions
(forward, input gradient and weight gradient, as `counting.py` counts them)
at the bf16 dense peak, against the device time of the kernels that cuDNN
launches for them.

A convolution pass may take several launches, and every one counts: cuDNN's
implicit-GEMM kernels of its forward ("fprop"), input gradient ("dgrad") and
weight gradient ("wgrad"), or, for many 1x1 and small convolutions, the
bf16 GEMMs of cuBLASLt that cuDNN hands them to ("nvjet_tst_*", CUTLASS's
"s16816gemm" with bf16 operands) and their split-K reductions into bf16;
cuDNN's own split-K reductions, workspace set-up and padding or layout
transforms. Nothing else of the learner or the policy runs a bf16 product:
the products of K5, of the heads and of the learned embeddings are float32
GEMMs ("f32f32", "sgemm", "gemv"), and none of them matches. cuDNN's
workspace memsets are not told apart from the others and are left out
(12 ms of a 15 s window of `resnet50.learn` on an H100).
"""

from benchmark import peaks
from benchmark.counting import flops

CALL_KIND = "conv"
NAMES = ("cudnn", "fprop", "dgrad", "wgrad", "convolve", "conv2d", "nchwToNhwc", "nhwcToNchw",
         "nvjet_tst_")
BF16 = ("bf16", "bfloat16")  # with "gemm" or "splitKreduce" in the name: a convolution's GEMM


def least_seconds(call) -> float:
    """The least time of a convolution Call's passes: its operations at the
    bf16 dense peak (multiply-adds count 2 operations)."""
    return flops(call) / peaks.BF16_FLOPS


def matches(kernel_name: str) -> bool:
    if any(k in kernel_name for k in NAMES):
        return True
    return (("gemm" in kernel_name or "splitKreduce" in kernel_name)
            and any(k in kernel_name for k in BF16))
