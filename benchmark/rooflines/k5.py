"""K5's roofline: Dense + bias + LayerNorm + tanh forward, and its backward
kernel (dh, dgamma, dbeta, dbias), from the shapes the loop gives them.

The product counts once, 2 M K D a member, at the TF32 peak, however many
passes an implementation makes; the bias, LayerNorm and tanh count 15
operations an output element forward and 18 backward, at the float32 peak.
Each input is read once and each output written once: forward x, W, bias,
gamma, beta in and y out; backward dy and y in, dh out (the dW and dx
products are torch.bmm's, not K5's). The least time of a call is the larger
of its bytes at the HBM rate and its product plus elementwise time.
"""

from benchmark import peaks

KERNELS = ("dense_ln_tanh_fwd_kernel", "dense_ln_tanh_bwd_kernel")
CALL_KIND = "dense_ln_tanh"
FWD_ELEMENTWISE = 15
BWD_ELEMENTWISE = 18
F32 = 4


def least_seconds(call) -> float:
    """The least time of a Call's K5 launches (forward, and the backward
    where a gradient passes through)."""
    form, e, k, d = call.shape
    m = call.rows
    x_rows = e * m if form == "member" else m
    out = e * m * d
    fwd_bytes = F32 * (x_rows * k + e * k * d + e * d + 2 * d + out)
    fwd = max(fwd_bytes / peaks.BYTES_PER_S,
              2 * e * m * k * d / peaks.TF32_FLOPS + FWD_ELEMENTWISE * out / peaks.FP32_FLOPS)
    bwd = 0.0
    if set(call.passes) - {"fwd"}:
        bwd_bytes = F32 * 3 * out
        bwd = max(bwd_bytes / peaks.BYTES_PER_S, BWD_ELEMENTWISE * out / peaks.FP32_FLOPS)
    return (fwd + bwd) * call.count


def matches(kernel_name: str) -> bool:
    return any(k in kernel_name for k in KERNELS)
