"""K5: y = tanh(LayerNorm(x W + b) * gamma + beta), the Dense fused in, with its backward.

Replaces: the Dense -> LayerNorm -> tanh triple of
`serl_tpu/networks/mlp.py::EnsembleMLP` (:115-122; `MLP` :41-47),
`serl_tpu/vision/encoders.py:135-137` (the bottleneck) and
`serl_tpu/vision/encoding.py:98-103` (the proprio Dense), which XLA fuses on
the TPU. LayerNorm runs over the last axis with flax's epsilon 1e-6, and one
(D,) gamma, beta serve every ensemble member, as the JAX ensemble shares one
LayerNorm.

`dense_layer_norm_tanh(x, kernel, bias, ln_weight, ln_bias, member_inputs)`
takes three input forms, each read in place (no copy of a weight per call):
  * x (..., K) through `nn.Linear`'s (D, K) `.weight` and (D,) `.bias`;
  * x (..., K) shared by the E members of an (E, K, D) kernel, (E, D) bias:
    the ensemble's first layer, output (E, ..., D);
  * x (E, ..., K) per member (`member_inputs=True`): the later layers.
`member_views` turns each into x3 (1 or E, M, K), w3 (E, K, D) and b2 (E, D)
views, the shapes that everything below takes.

Two implementations of each direction sit side by side:
  * `dense_layer_norm_tanh_forward_plain` / `..._backward_plain`: the
    kernels' arithmetic in plain PyTorch (h = x @ W + b by torch.matmul, the
    two-pass variance). CPU tensors take them; on the card only tests and
    chip_smoke.py call them.
  * the CUDA kernels in `serl_tpu_torch/csrc/dense_layer_norm_tanh.cu`,
    which `dense_layer_norm_tanh_forward` and `..._backward` launch for CUDA
    tensors, or raise, counting their launches in `.launches`. The source
    says what bounds them and how the design meets it: the forward is a
    3xTF32 tensor-core product with the LayerNorm and tanh in its epilogue;
    where the row blocks leave SMs idle (few rows, or the ResNet heads'
    K = 4,096) the forward splits K over several blocks a row tile and the
    last of them adds their partials in a fixed order; the backward writes
    dh and, with weight grads, dgamma, dbeta and the Dense's dbias per
    member, summed in a fixed order in the same launch.
The backward's two matrix products, dW = x^T dh and dx = dh W^T (summed over
the members for a shared input), stay torch.matmul / torch.bmm, as the JAX
package leaves them to XLA.

The host path is kept short, since at the main path's sizes a call's host
time is larger than its device time: shape and type checks only, the outputs
from one `torch.empty`, the current stream, a device context only for a
tensor off the current device. Under no_grad (the target critic, the next
actions, acting) the forward stores only y. The tickets of the backward and
of the split forward use one zeroed int32 counter array per device, which
each launch leaves zeroed, and the split forward one scratch buffer per
device: two K5 launches must not run at once on one device (the port uses
one stream).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, field
from typing import Iterator, List

import torch

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default
SUPPORTED_D = (64, 128, 256)  # the kernels' LayerNorm widths
# When a set, every `dense_layer_norm_tanh` call adds its (form, E, M, K, D)
# ("linear", "shared" or "member", as `member_views` reads them), and every
# backward through one adds (form, E, M, K, D, weight grads, dx): how a
# caller learns the shapes that a run gives K5.
shape_log = None
N_COUNTERS = 1 << 14  # tickets per device: backward 1 + E + E * groups; split forward a tile
# When a number, every launch of the forward kernel adds its product's
# 2 * E * M * K * D float operations (`product_flops`): the work that
# torch.utils.flop_counter.FlopCounterMode counts in the plain version's
# torch.matmul and cannot see in a ctypes launch. CPU tensors add nothing
# here (FlopCounterMode counts their matmul), so a count over both reads the
# same work whichever implementation ran (`tools/perf_speed_of_light.py::
# counted_flops`).
flops = None


def member_views(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, member_inputs: bool):
    """(x3 (1 or E, M, K), w3 (E, K, D), b2 (E, D), the output's shape) for
    the three input forms; views wherever x's rows allow."""
    k = x.shape[-1]
    if kernel.dim() == 2:  # nn.Linear: (D, K) weight, (D,) bias
        return (x.reshape(1, -1, k), kernel.t().unsqueeze(0), bias.unsqueeze(0),
                x.shape[:-1] + (kernel.shape[0],))
    e, _, d = kernel.shape
    if member_inputs:
        return x.reshape(e, -1, k), kernel, bias, x.shape[:-1] + (d,)
    return x.reshape(1, -1, k), kernel, bias, (e,) + tuple(x.shape[:-1]) + (d,)


# ---------------------------------------------------------------- plain


def dense_layer_norm_tanh_forward_plain(x3, w3, b2, ln_weight, ln_bias):
    """(y, h, mean, rstd): y and the pre-activation h (E, M, D), the row
    statistics (E, M), as the forward kernel computes them."""
    h = torch.matmul(x3, w3) + b2[:, None, :]
    mean = h.mean(-1)
    hc = h - mean[..., None]
    rstd = torch.rsqrt((hc * hc).mean(-1) + LAYER_NORM_EPS)
    y = torch.tanh(hc * rstd[..., None] * ln_weight + ln_bias)
    return y, h, mean, rstd


def dense_layer_norm_tanh_backward_plain(dy, y, h, mean, rstd, ln_weight, need_weight_grads=True):
    """(dh, dgamma, dbeta, dbias) for the saved forward, as the backward
    kernel computes them: dh (E, M, D), dgamma and dbeta (D,) over every
    member's rows, dbias (E, D) per member; the last three are None unless
    `need_weight_grads`."""
    g = dy * (1.0 - y * y)
    x_hat = (h - mean[..., None]) * rstd[..., None]
    gw = g * ln_weight
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * x_hat).mean(-1, keepdim=True)
    dh = rstd[..., None] * (gw - c1 - x_hat * c2)
    if not need_weight_grads:
        return dh, None, None, None
    return dh, (g * x_hat).sum((0, 1)), g.sum((0, 1)), dh.sum(1)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _library():
    """Build (once per source hash) and bind the two kernels; returns (lib,
    backward rows per block, backward blocks per group)."""
    from serl_tpu_torch.native.build import load_library

    lib = load_library("dense_layer_norm_tanh")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.serl_dense_ln_tanh_forward.argtypes = [
        p, i64, i64, p, i64, i32, p, i64, p, p, p, p, p, p, i32, i32, i32, i32, ctypes.c_float,
        p, i64, p, i32, p]
    lib.serl_dense_ln_tanh_forward.restype = i32
    lib.serl_dense_ln_tanh_backward.argtypes = [p] * 7 + [i32] * 3 + [p] * 5 + [i32, p]
    lib.serl_dense_ln_tanh_backward.restype = i32
    lib.serl_dense_ln_tanh_error_string.argtypes = [i32]
    lib.serl_dense_ln_tanh_error_string.restype = ctypes.c_char_p
    config = (ctypes.c_int * 2)()
    lib.serl_dense_ln_tanh_config(config)
    return lib, config[0], config[1]


_COUNTERS = {}
_PARTIAL = {}


def _counters(device: torch.device) -> torch.Tensor:
    counters = _COUNTERS.get(device.index)
    if counters is None:
        counters = _COUNTERS[device.index] = torch.zeros(N_COUNTERS, dtype=torch.int32,
                                                         device=device)
    return counters


def _partial(device: torch.device) -> torch.Tensor:
    """The split forward's scratch: a wave of 16-row tiles' accumulators at
    the widest D (the kernel splits no further than it holds)."""
    partial = _PARTIAL.get(device.index)
    if partial is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        partial = _PARTIAL[device.index] = torch.empty(sms * 16 * max(SUPPORTED_D), device=device)
    return partial


def _launch(device: torch.device, call) -> None:
    """call(stream) on `device`'s current stream; raises for a failed launch."""
    if device.index == torch.cuda.current_device():
        rc = call(torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = call(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError("dense_layer_norm_tanh kernel launch failed: "
                           f"{_library()[0].serl_dense_ln_tanh_error_string(rc).decode()}")


def _bad(what: str, *tensors) -> ValueError:
    return ValueError(f"dense_layer_norm_tanh: {what}; got "
                      + ", ".join(f"{t.dtype} {tuple(t.shape)} {t.stride()} on {t.device}"
                                  for t in tensors))


def dense_layer_norm_tanh_forward(x3, w3, b2, ln_weight, ln_bias, save=False):
    """(y, h, mean, rstd) of `member_views`' forms; h, mean and rstd (what
    the backward needs) are None unless `save`. The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or raise); a launch adds its
    product's operations to `flops` when that is a number."""
    global flops
    device = x3.device
    if device.type == "cpu":
        y, h, mean, rstd = dense_layer_norm_tanh_forward_plain(x3, w3, b2, ln_weight, ln_bias)
        return (y, h, mean, rstd) if save else (y, None, None, None)
    if device.type != "cuda":
        raise ValueError(f"dense_layer_norm_tanh: no kernel for {device}")
    ex, m, k = x3.shape
    e, _, d = w3.shape
    tensors = (x3, w3, b2, ln_weight, ln_bias)
    if any(t.dtype != torch.float32 or t.device != device for t in tensors):
        raise _bad(f"want float32 tensors on {device}", *tensors)
    if (d not in SUPPORTED_D or w3.shape[1] != k or ex not in (1, e) or b2.shape != (e, d)
            or ln_weight.shape != (d,) or ln_bias.shape != (d,)):
        raise _bad(f"want x (1 or E, M, K), W (E, K, D), b (E, D), gamma, beta (D,), "
                   f"D in {SUPPORTED_D}", *tensors)
    sx, sw, sb = x3.stride(), w3.stride(), b2.stride()
    if sw[1:] == (d, 1):
        layout_kd = 1
    elif sw[1:] == (1, k):
        layout_kd = 0
    else:
        raise _bad("want W's (K, D) or (D, K) rows contiguous", w3)
    if sx[2] != 1 or sb[1] != 1 or ln_weight.stride(0) != 1 or ln_bias.stride(0) != 1:
        raise _bad("want x, b, gamma and beta with unit stride along their last axis", *tensors)
    n = e * m * d
    if save:  # one allocation: y, h, mean, rstd
        out = torch.empty(2 * n + 2 * e * m, device=device)
        y = out.as_strided((e, m, d), (m * d, d, 1))
        h = out.as_strided((e, m, d), (m * d, d, 1), n)
        mean = out.as_strided((e, m), (m, 1), 2 * n)
        rstd = out.as_strided((e, m), (m, 1), 2 * n + e * m)
        h_ptr, mean_ptr, rstd_ptr = h.data_ptr(), mean.data_ptr(), rstd.data_ptr()
    else:
        y, h, mean, rstd = torch.empty((e, m, d), device=device), None, None, None
        h_ptr = mean_ptr = rstd_ptr = None
    lib = _library()[0]
    partial = _partial(device)
    _launch(device, lambda stream: lib.serl_dense_ln_tanh_forward(
        x3.data_ptr(), sx[0] if ex > 1 else 0, sx[1], w3.data_ptr(), sw[0] if e > 1 else 0,
        layout_kd, b2.data_ptr(), sb[0] if e > 1 else 0, ln_weight.data_ptr(),
        ln_bias.data_ptr(), y.data_ptr(), h_ptr, mean_ptr, rstd_ptr, e, m, k, d, LAYER_NORM_EPS,
        partial.data_ptr(), partial.numel(), _counters(device).data_ptr(), N_COUNTERS, stream))
    dense_layer_norm_tanh_forward.launches += 1
    if flops is not None:
        flops += product_flops(("", e, m, k, d))
    return y, h, mean, rstd


dense_layer_norm_tanh_forward.launches = 0


def dense_layer_norm_tanh_backward(dy, y, h, mean, rstd, ln_weight, need_weight_grads=True):
    """(dh, dgamma, dbeta, dbias) for the saved forward (E, M, D); the last
    three are None unless `need_weight_grads`. The plain version for CPU
    tensors, one launch of the CUDA kernel for CUDA tensors (or raise)."""
    device = y.device
    if device.type == "cpu":
        return dense_layer_norm_tanh_backward_plain(dy, y, h, mean, rstd, ln_weight,
                                                    need_weight_grads)
    if device.type != "cuda":
        raise ValueError(f"dense_layer_norm_tanh: no kernel for {device}")
    e, m, d = y.shape
    tensors = (dy, y, h, mean, rstd, ln_weight)
    if any(t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
           for t in tensors):
        raise _bad(f"want contiguous float32 tensors on {device}", *tensors)
    if (d not in SUPPORTED_D or dy.shape != y.shape or h.shape != y.shape
            or mean.shape != (e, m) or rstd.shape != (e, m) or ln_weight.shape != (d,)):
        raise _bad("want dy, y, h (E, M, D), mean, rstd (E, M), gamma (D,)", *tensors)
    lib, bwd_rows, group = _library()
    n = e * m * d
    if need_weight_grads:  # one allocation: dh, dgamma, dbeta, dbias, then the scratch
        tiles = -(-m // bwd_rows)
        groups = -(-tiles // group)
        scratch_n = e * (tiles + groups) * 3 * d + e * 2 * d
        out = torch.empty(n + (2 + e) * d + scratch_n, device=device)
        dh = out.as_strided((e, m, d), (m * d, d, 1))
        dgamma, dbeta = out.as_strided((d,), (1,), n), out.as_strided((d,), (1,), n + d)
        dbias = out.as_strided((e, d), (d, 1), n + 2 * d)
        ptrs = (out.data_ptr() + 4 * (n + (2 + e) * d), dgamma.data_ptr(), dbeta.data_ptr(),
                dbias.data_ptr(), _counters(device).data_ptr())
    else:
        dh, dgamma, dbeta, dbias = torch.empty_like(y), None, None, None
        ptrs = (None,) * 5
    _launch(device, lambda stream: lib.serl_dense_ln_tanh_backward(
        dy.data_ptr(), y.data_ptr(), h.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        ln_weight.data_ptr(), dh.data_ptr(), e, m, d, *ptrs, N_COUNTERS, stream))
    dense_layer_norm_tanh_backward.launches += 1
    return dh, dgamma, dbeta, dbias


dense_layer_norm_tanh_backward.launches = 0


def call_shape(x: torch.Tensor, kernel: torch.Tensor, member_inputs: bool) -> tuple:
    """(form, E, M, K, D) of a `dense_layer_norm_tanh` call."""
    k = x.shape[-1]
    if kernel.dim() == 2:
        return ("linear", 1, x.numel() // k, k, kernel.shape[0])
    e, _, d = kernel.shape
    if member_inputs:
        return ("member", e, x.numel() // (k * e), k, d)
    return ("shared", e, x.numel() // k, k, d)


def product_flops(shape: tuple) -> int:
    """2 * E * M * K * D: the float operations of the Dense product of a call
    of `call_shape`'s (form, E, M, K, D), as FlopCounterMode counts the plain
    version's torch.matmul, and as the forward kernel adds them to `flops`."""
    _, e, m, k, d = shape[:5]
    return 2 * e * m * k * d


@dataclass
class Counts:
    """The host counts of a block of K5 calls (`counts_apart`): the forward's
    and the backward's launches, the shapes the calls logged (one entry a
    call) and the FLOPs the products added."""

    forward: int = 0
    backward: int = 0
    shapes: List[tuple] = field(default_factory=list)
    flops: int = 0

    def add(self) -> None:
        """Adds the block's counts to the module's, as launching its calls
        again would: the launches, and the shapes and FLOPs where
        `shape_log` and `flops` take them."""
        global flops
        dense_layer_norm_tanh_forward.launches += self.forward
        dense_layer_norm_tanh_backward.launches += self.backward
        if shape_log is not None:
            for shape in self.shapes:
                shape_log.add(shape)
        if flops is not None:
            flops += self.flops


class _ShapeList(list):
    add = list.append


@contextlib.contextmanager
def counts_apart() -> Iterator[Counts]:
    """Yields the `Counts` of the block's calls, which the module's counts
    leave out: a CUDA graph's capture calls K5 but launches nothing, and each
    replay launches the captured kernels without a call, so the replay adds
    the capture's counts (agents/graphs.py)."""
    global shape_log, flops
    fw, bw = dense_layer_norm_tanh_forward, dense_layer_norm_tanh_backward
    outer = shape_log, flops, fw.launches, bw.launches
    counts = Counts()
    shape_log, flops = _ShapeList(), 0
    try:
        yield counts
    finally:
        counts.shapes, counts.flops = list(shape_log), flops
        counts.forward, counts.backward = fw.launches - outer[2], bw.launches - outer[3]
        shape_log, flops, fw.launches, bw.launches = outer


class _DenseLayerNormTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, ln_weight, ln_bias, member_inputs):
        x3, w3, b2, out_shape = member_views(x, kernel, bias, member_inputs)
        y, h, mean, rstd = dense_layer_norm_tanh_forward(x3, w3, b2, ln_weight, ln_bias, save=True)
        ctx.save_for_backward(x3, w3, y, h, mean, rstd, ln_weight)
        ctx.x_shape, ctx.linear, ctx.member_inputs = x.shape, kernel.dim() == 2, member_inputs
        ctx.call_shape = None if shape_log is None else call_shape(x, kernel, member_inputs)
        return y.view(out_shape)

    @staticmethod
    def backward(ctx, dy):
        x3, w3, y, h, mean, rstd, ln_weight = ctx.saved_tensors
        need_x, need_w, need_b, need_gamma, need_beta, _ = ctx.needs_input_grad
        if shape_log is not None and ctx.call_shape is not None:
            shape_log.add(ctx.call_shape + (need_w or need_b or need_gamma or need_beta, need_x))
        dh, dgamma, dbeta, dbias = dense_layer_norm_tanh_backward(
            dy.contiguous().view(y.shape), y, h, mean, rstd, ln_weight,
            need_weight_grads=need_w or need_b or need_gamma or need_beta)
        dx = dw = None
        if ctx.linear:  # x (M, K), weight (D, K)
            if need_x:
                dx = dh[0] @ w3[0].t()
            if need_w:
                dw = dh[0].t() @ x3[0]
            dbias = None if dbias is None else dbias[0]
        else:
            if need_x:
                dx = torch.bmm(dh, w3.transpose(1, 2))
                if not ctx.member_inputs:  # one input through every member
                    dx = dx.sum(0)
            if need_w:
                dw = (torch.bmm(x3.transpose(1, 2), dh) if ctx.member_inputs
                      else torch.matmul(x3[0].t(), dh))
        return (None if dx is None else dx.view(ctx.x_shape), dw, dbias if need_b else None,
                dgamma if need_gamma else None, dbeta if need_beta else None, None)


def dense_layer_norm_tanh(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                          ln_weight: torch.Tensor, ln_bias: torch.Tensor,
                          member_inputs: bool = False) -> torch.Tensor:
    """tanh(LayerNorm(x W + b) * ln_weight + ln_bias) over the last axis, eps
    1e-6, for the three input forms of the module docstring; differentiable
    in every tensor. Without autograd (no_grad, or no input that needs a
    grad) the forward stores only y."""
    if shape_log is not None:
        shape_log.add(call_shape(x, kernel, member_inputs))
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad or bias.requires_grad
                                    or ln_weight.requires_grad or ln_bias.requires_grad):
        return _DenseLayerNormTanh.apply(x, kernel, bias, ln_weight, ln_bias, member_inputs)
    x3, w3, b2, out_shape = member_views(x, kernel, bias, member_inputs)
    return dense_layer_norm_tanh_forward(x3, w3, b2, ln_weight, ln_bias)[0].view(out_shape)
