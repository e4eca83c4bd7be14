"""K5: y = tanh(LayerNorm(x) * weight + bias) over the last axis, with its backward.

Replaces: the LayerNorm -> tanh pair of `serl_tpu/networks/mlp.py::EnsembleMLP`
(:120-122) and `MLP` (:45-47), which XLA fuses on the TPU. One (D,) weight
and bias serve every row, which is how the JAX ensemble shares one LayerNorm
across its members. Epsilon is flax's 1e-6.

Two implementations of each direction sit side by side:
  * `layer_norm_tanh_forward_plain` / `layer_norm_tanh_backward_plain`: the
    kernels' arithmetic in plain PyTorch. CPU tensors take them; on the card
    only tests and chip_smoke.py call them.
  * Triton kernels (`_kernels`): `layer_norm_tanh_forward` and
    `layer_norm_tanh_backward` launch them for CUDA tensors, or raise, and
    count their launches in `.launches`. Triton is imported at the first
    launch, never at import.
`layer_norm_tanh(x, weight, bias)` is the autograd op over the two.

Forward: one program per block of rows holds the rows in registers, takes
the mean and the (two-pass) variance in fp32, normalises, scales, shifts and
applies tanh; it saves y and the per-row mean and rstd. Backward, with
g = dy * (1 - y^2) and x_hat = (x - mean) * rstd:
    dx = rstd * (g*w - mean(g*w) - x_hat * mean(g*w*x_hat))
and dw = sum(g * x_hat), db = sum(g) over all rows: each program writes its
column partial sums, and a second small kernel adds them in a fixed order
(no atomics, so a result repeats bit for bit). When autograd needs no dw/db
(the actor loss's pass through the critic, whose params are constants
there) the partials are skipped.

What bounds it on an H100: a few float operations per element against 8
bytes (fp32 in and out) forward and 16 bytes (dy, x, y in; dx out)
backward, far below the card's ~20 operations per byte of fp32, so bytes
bound it: 5.2 MB forward for the critic's (10, 256, 256) call, ~1.6 us at
3.35 TB/s. At the main path's sizes a launch (a few us) costs as much as
that, so the design keeps to one launch forward and two backward, reads
each input once and keeps a row's statistics in registers.
"""

from __future__ import annotations

import functools

import torch

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default
BLOCK_ROWS = 16  # rows per program


# ---------------------------------------------------------------- plain


def layer_norm_tanh_forward_plain(x2d, weight, bias):
    """(y, mean, rstd) of (M, D) rows, as the forward kernel computes them."""
    mean = x2d.mean(-1)
    xc = x2d - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + LAYER_NORM_EPS)
    y = torch.tanh(xc * rstd[:, None] * weight + bias)
    return y, mean, rstd


def layer_norm_tanh_backward_plain(dy, x2d, weight, mean, rstd, y, need_weight_grads=True):
    """(dx, dweight, dbias) of (M, D) rows, as the backward kernels compute
    them; dweight and dbias are None unless `need_weight_grads`."""
    g = dy * (1.0 - y * y)
    x_hat = (x2d - mean[:, None]) * rstd[:, None]
    gw = g * weight
    c1 = gw.mean(-1, keepdim=True)
    c2 = (gw * x_hat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (gw - c1 - x_hat * c2)
    if not need_weight_grads:
        return dx, None, None
    return dx, (g * x_hat).sum(0), g.sum(0)


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and define the three kernels (first launch only):
    (forward, backward, column sum)."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def layer_norm_tanh_fwd_kernel(X, W, B, Y, MEAN, RSTD, M, D, eps,
                                   BLOCK_M: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < M
        cmask = cols < D
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None] * D + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0)
        mean = tl.sum(x, axis=1) / D
        xc = tl.where(mask, x - mean[:, None], 0.0)
        rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=1) / D + eps)
        w = tl.load(W + cols, mask=cmask, other=0.0)
        b = tl.load(B + cols, mask=cmask, other=0.0)
        z = xc * rstd[:, None] * w[None, :] + b[None, :]
        # tanh(z) = sign(z) * (1 - e) / (1 + e) with e = exp(-2|z|) in (0, 1]
        e = tl.exp(-2.0 * tl.abs(z))
        t = (1.0 - e) / (1.0 + e)
        tl.store(Y + offs, tl.where(z < 0.0, -t, t), mask=mask)
        tl.store(MEAN + rows, mean, mask=rmask)
        tl.store(RSTD + rows, rstd, mask=rmask)

    @triton.jit
    def layer_norm_tanh_bwd_kernel(DY, X, W, MEAN, RSTD, Y, DX, PARTIAL, M, D, P,
                                   BLOCK_M: tl.constexpr, BLOCK_D: tl.constexpr,
                                   WEIGHT_GRADS: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < M
        cmask = cols < D
        mask = rmask[:, None] & cmask[None, :]
        offs = rows[:, None] * D + cols[None, :]
        dy = tl.load(DY + offs, mask=mask, other=0.0)
        x = tl.load(X + offs, mask=mask, other=0.0)
        y = tl.load(Y + offs, mask=mask, other=0.0)
        mean = tl.load(MEAN + rows, mask=rmask, other=0.0)
        rstd = tl.load(RSTD + rows, mask=rmask, other=0.0)
        w = tl.load(W + cols, mask=cmask, other=0.0)
        g = dy * (1.0 - y * y)
        x_hat = tl.where(mask, (x - mean[:, None]) * rstd[:, None], 0.0)
        gw = g * w[None, :]
        c1 = tl.sum(gw, axis=1) / D
        c2 = tl.sum(gw * x_hat, axis=1) / D
        dx = rstd[:, None] * (gw - c1[:, None] - x_hat * c2[:, None])
        tl.store(DX + offs, dx, mask=mask)
        if WEIGHT_GRADS:
            # PARTIAL is (2, P, D): this program's column sums of g*x_hat, g
            tl.store(PARTIAL + pid * D + cols, tl.sum(g * x_hat, axis=0), mask=cmask)
            tl.store(PARTIAL + (P + pid) * D + cols, tl.sum(g, axis=0), mask=cmask)

    @triton.jit
    def layer_norm_tanh_colsum_kernel(PARTIAL, OUT, P, D, BLOCK_P: tl.constexpr,
                                      BLOCK_D: tl.constexpr):
        # OUT[k, c] = sum over p of PARTIAL[k, p, c], k = program_id(1), in p order
        k = tl.program_id(1)
        cols = tl.program_id(0) * BLOCK_D + tl.arange(0, BLOCK_D)
        cmask = cols < D
        acc = tl.zeros([BLOCK_D], dtype=tl.float32)
        for start in range(0, P, BLOCK_P):
            r = start + tl.arange(0, BLOCK_P)
            m = (r < P)[:, None] & cmask[None, :]
            part = tl.load(PARTIAL + (k * P + r[:, None]) * D + cols[None, :], mask=m, other=0.0)
            acc += tl.sum(part, axis=0)
        tl.store(OUT + k * D + cols, acc, mask=cmask)

    return layer_norm_tanh_fwd_kernel, layer_norm_tanh_bwd_kernel, layer_norm_tanh_colsum_kernel


def _block_d(d: int) -> int:
    return 1 << max(d - 1, 1).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"layer_norm_tanh {name}: want float32 {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"layer_norm_tanh {name} must be contiguous")


def layer_norm_tanh_forward(x2d, weight, bias):
    """(y, mean, rstd) of contiguous fp32 (M, D) rows: the plain version for
    CPU tensors, the Triton kernel for CUDA tensors (or raise)."""
    m, d = x2d.shape
    for name, t, shape in (("x", x2d, (m, d)), ("weight", weight, (d,)), ("bias", bias, (d,))):
        _check(name, t, shape, x2d.device)
    if x2d.device.type == "cpu":
        return layer_norm_tanh_forward_plain(x2d, weight, bias)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm_tanh: no kernel for {x2d.device}")
    fwd_kernel, _, _ = _kernels()
    y = torch.empty_like(x2d)
    mean = torch.empty(m, device=x2d.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    grid = (_cdiv(m, BLOCK_ROWS),)
    with torch.cuda.device(x2d.device):
        fwd_kernel[grid](x2d, weight, bias, y, mean, rstd, m, d, LAYER_NORM_EPS,
                         BLOCK_M=BLOCK_ROWS, BLOCK_D=_block_d(d), num_warps=4)
    layer_norm_tanh_forward.launches += 1
    return y, mean, rstd


layer_norm_tanh_forward.launches = 0


def layer_norm_tanh_backward(dy, x2d, weight, mean, rstd, y, need_weight_grads=True):
    """(dx, dweight, dbias) for the saved forward of (M, D) rows; dweight and
    dbias are None unless `need_weight_grads`. Plain version for CPU tensors,
    the Triton kernels for CUDA tensors (or raise). `.launches` counts the
    backward kernel, `.colsum_launches` the column-sum kernel that a call
    with weight grads launches after it."""
    m, d = x2d.shape
    device = x2d.device
    for name, t, shape in (("dy", dy, (m, d)), ("x", x2d, (m, d)), ("weight", weight, (d,)),
                           ("mean", mean, (m,)), ("rstd", rstd, (m,)), ("y", y, (m, d))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return layer_norm_tanh_backward_plain(dy, x2d, weight, mean, rstd, y, need_weight_grads)
    if device.type != "cuda":
        raise ValueError(f"layer_norm_tanh: no kernel for {device}")
    _, bwd_kernel, colsum_kernel = _kernels()
    programs = _cdiv(m, BLOCK_ROWS)
    dx = torch.empty_like(x2d)
    partial = (torch.empty((2, programs, d), device=device, dtype=torch.float32)
               if need_weight_grads else dx)  # unused pointer when no dw/db
    with torch.cuda.device(device):
        bwd_kernel[(programs,)](dy, x2d, weight, mean, rstd, y, dx, partial, m, d, programs,
                                BLOCK_M=BLOCK_ROWS, BLOCK_D=_block_d(d),
                                WEIGHT_GRADS=need_weight_grads, num_warps=4)
        if need_weight_grads:
            sums = torch.empty((2, d), device=device, dtype=torch.float32)
            colsum_kernel[(_cdiv(d, 64), 2)](partial, sums, programs, d,
                                             BLOCK_P=32, BLOCK_D=64, num_warps=2)
            layer_norm_tanh_backward.colsum_launches += 1
    layer_norm_tanh_backward.launches += 1
    if not need_weight_grads:
        return dx, None, None
    return dx, sums[0], sums[1]


layer_norm_tanh_backward.launches = 0
layer_norm_tanh_backward.colsum_launches = 0


class _LayerNormTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        if not x.is_contiguous():
            raise ValueError("layer_norm_tanh x must be contiguous")
        x2d = x.view(-1, x.shape[-1])
        y, mean, rstd = layer_norm_tanh_forward(x2d, weight, bias)
        ctx.save_for_backward(x2d, weight, mean, rstd, y)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mean, rstd, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx, dw, db = layer_norm_tanh_backward(dy.contiguous().view(y.shape), x2d, weight, mean,
                                              rstd, y, need_weight_grads=need_w or need_b)
        return (dx.view(dy.shape) if need_x else None, dw if need_w else None,
                db if need_b else None)


def layer_norm_tanh(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """tanh(LayerNorm(x) * weight + bias) over the last axis of contiguous
    fp32 `x`, eps 1e-6; differentiable in x, weight and bias."""
    return _LayerNormTanh.apply(x, weight, bias)
