"""K5's kernels against their plain versions on the card: inputs and the rule.

chip_smoke.py and the `cuda`-marked test of tests/test_torch_dense_layer_norm_tanh.py
hold `dense_layer_norm_tanh_forward` / `_backward` (the CUDA kernels) to
`dense_layer_norm_tanh_forward_plain` / `_backward_plain` on the same fp32
inputs with this rule. It imports torch and the port only (no JAX), so
chip_smoke.py can load it on a machine without JAX.

The rule, and why:
  * h, the Dense's output: |h - h_plain| <= REL_H * max(|x| @ |W| + |b|).
    The kernel sums the K products as 3xTF32 tensor-core products (each
    operand split into two TF32 halves; the small x small term is dropped
    and each small half rounded, <= 3 * 2^-24 of |x w| a product) in its
    own order; the plain matmul sums fp32 products in cuBLAS's order. Each
    rounds by ~sqrt(K) * 2^-24 of the sum of |products| (1.4e-6 at K =
    580), K * 2^-24 at worst (3.5e-5).
  * y, mean, rstd against the plain LayerNorm and tanh of the kernel's own
    h, so that the epilogue is judged apart from the product: y to ATOL_Y
    abs (row sums of D floats in another order, scaled by rstd, and expf
    against torch.tanh, a few ulp of outputs in (-1, 1)); mean to REL_H of
    the row's largest |h|; rstd to REL_RSTD of itself.
  * y against the plain forward end to end: ATOL_Y plus what the allowed
    error in h can move it, 3 * rstd * |gamma| * REL_H * max(|x| @ |W| + |b|)
    for the worst row (the error enters through h, its mean and its spread).
  * the backward, both fed the plain forward's y, h, mean and rstd: dh to
    REL_DH of the call's largest |dh| (two row sums of D floats in another
    order, through rstd); dgamma, dbeta and dbias to REL_SUMS of their
    column sums of |g x_hat|, |g| and |dh| (sums over up to 20,480 rows in
    another order: fixed-order partials against torch's reduction,
    ~sqrt(n) * 2^-24 = 8.5e-6 of those sums).
"""

import math

import torch

from serl_tpu_torch.networks import dense_layer_norm_tanh as k5

REL_H = 1e-5
ATOL_Y = 1e-5
REL_RSTD = 1e-5
REL_DH = 2.5e-5
REL_SUMS = 5e-5


def inputs(form: str, e: int, m: int, k: int, d: int, generator, device):
    """(x, kernel, bias, gamma, beta, dy) as the networks hold them: x in
    (-1, 1) (normalised observations, or tanh activations); a xavier-uniform
    kernel, (D, K) for "linear" (nn.Linear) else (E, K, D); small non-zero
    biases; perturbed gamma and beta. x is (M, K), or (E, M, K) for
    "member"."""
    u = lambda *shape: torch.rand(shape, generator=generator, device=device) * 2 - 1
    n = lambda *shape: torch.randn(shape, generator=generator, device=device)
    x = u(*((e,) if form == "member" else ()), m, k)
    bound = math.sqrt(6.0 / (k + d))
    if form == "linear":
        kernel, bias = bound * u(d, k), 0.1 * n(d)
    else:
        kernel, bias = bound * u(e, k, d), 0.1 * n(e, d)
    gamma, beta = 1.0 + 0.3 * n(d), 0.2 * n(d)
    dy = n(e, m, d)
    return x, kernel, bias, gamma, beta, dy


def _ln_tanh(h, gamma, beta):
    mean = h.mean(-1)
    hc = h - mean[..., None]
    rstd = torch.rsqrt((hc * hc).mean(-1) + k5.LAYER_NORM_EPS)
    return torch.tanh(hc * rstd[..., None] * gamma + beta), mean, rstd


def forward_errors(x3, w3, b2, gamma, beta, y, h, mean, rstd):
    """({name: error}, {name: limit}) of a saved forward (y, h, mean, rstd)."""
    py, ph, _, prstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
    scale = float((torch.matmul(x3.abs(), w3.abs()) + b2.abs()[:, None, :]).max())
    ey, emean, erstd = _ln_tanh(h, gamma, beta)
    y_end = 3 * float(prstd.max()) * float(gamma.abs().max()) * REL_H * scale
    errs = {"h": float((h - ph).abs().max()) / scale,
            "y": float((y - ey).abs().max()),
            "mean": float(((mean - emean).abs() / h.abs().amax(-1)).max()),
            "rstd": float(((rstd - erstd).abs() / erstd).max()),
            "y_end_to_end": float((y - py).abs().max())}
    limits = {"h": REL_H, "y": ATOL_Y, "mean": REL_H, "rstd": REL_RSTD,
              "y_end_to_end": ATOL_Y + y_end}
    return errs, limits


def backward_errors(dy, y, h, mean, rstd, gamma, dh, dgamma, dbeta, dbias):
    """({name: error}, {name: limit}) of the backward kernel's outputs for
    the plain forward's (y, h, mean, rstd); dgamma, dbeta and dbias may be
    None (no weight grads)."""
    pdh, pdgamma, pdbeta, pdbias = k5.dense_layer_norm_tanh_backward_plain(
        dy, y, h, mean, rstd, gamma)
    errs = {"dh": float((dh - pdh).abs().max() / pdh.abs().max())}
    if dgamma is not None:
        g = dy * (1.0 - y * y)
        x_hat = (h - mean[..., None]) * rstd[..., None]
        errs["dgamma"] = float((dgamma - pdgamma).abs().max()
                               / (g * x_hat).abs().sum((0, 1)).max())
        errs["dbeta"] = float((dbeta - pdbeta).abs().max() / g.abs().sum((0, 1)).max())
        errs["dbias"] = float((dbias - pdbias).abs().max() / pdh.abs().sum(1).max())
    limits = {name: REL_DH if name == "dh" else REL_SUMS for name in errs}
    return errs, limits


def failures(errs: dict, limits: dict):
    return [f"{name} {errs[name]:.3g} > {limits[name]:.3g}" for name in errs
            if not errs[name] <= limits[name]]
