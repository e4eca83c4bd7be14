"""K5, tanh(LayerNorm(x) * w + b), against flax's LayerNorm + tanh, on the CPU.

The port's plain versions (the kernels' arithmetic in torch, which CPU
tensors take) are held to flax `nn.LayerNorm()` + `jnp.tanh`, forward, and
to `jax.grad` of a weighted sum of it, backward, on numpy inputs with a
non-zero row mean (as a Dense output has) and perturbed weight and bias.
Tolerance: forward 2e-6 abs (outputs in (-1, 1); flax takes the variance as
E[x^2] - E[x]^2, the port in two passes, which differ by float32 rounding of
sums of 256 squares); dx 1e-5 abs (|dx| is up to ~3 here, the same
rounding through rstd); dw, db 1e-6 relative to the column sums of
|g*x_hat| and |g| (sums over all E*B rows in another order; the largest
seen is 9e-8).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu_torch.networks import layer_norm_tanh as k5

SHAPES = [(4, 16, 32), (24, 256)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + rng.normal(size=shape[:-1] + (1,))).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(d,))).astype(np.float32)
    b = (0.2 * rng.normal(size=(d,))).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, w, b, dy


def _flax(x, w, b):
    return jnp.tanh(fnn.LayerNorm().apply({"params": {"scale": w, "bias": b}}, x))


@pytest.mark.parametrize("shape", SHAPES)
def test_torch_layer_norm_tanh_plain_matches_flax(shape):
    x, w, b, dy = _inputs(shape, 0)
    want = np.asarray(_flax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    y, mean, rstd = k5.layer_norm_tanh_forward_plain(torch.from_numpy(x).reshape(-1, shape[-1]),
                                                     torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(y.reshape(shape).numpy(), want, atol=2e-6, rtol=0)

    jdx, jdw, jdb = jax.grad(lambda x, w, b: jnp.sum(_flax(x, w, b) * dy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    d = shape[-1]
    dx, dw, db = k5.layer_norm_tanh_backward_plain(
        torch.from_numpy(dy).reshape(-1, d), torch.from_numpy(x).reshape(-1, d),
        torch.from_numpy(w), mean, rstd, y)
    np.testing.assert_allclose(dx.reshape(shape).numpy(), np.asarray(jdx), atol=1e-5, rtol=0)
    g = (dy * (1 - want ** 2)).reshape(-1, d)
    x_hat = ((x.reshape(-1, d) - mean.numpy()[:, None]) * rstd.numpy()[:, None])
    assert np.abs(dw.numpy() - np.asarray(jdw)).max() <= 1e-6 * np.abs(g * x_hat).sum(0).max()
    assert np.abs(db.numpy() - np.asarray(jdb)).max() <= 1e-6 * np.abs(g).sum(0).max()
    _, no_dw, no_db = k5.layer_norm_tanh_backward_plain(
        torch.from_numpy(dy).reshape(-1, d), torch.from_numpy(x).reshape(-1, d),
        torch.from_numpy(w), mean, rstd, y, need_weight_grads=False)
    assert no_dw is None and no_db is None


def test_torch_layer_norm_tanh_autograd_op_on_cpu():
    """The autograd op runs the plain versions for CPU tensors (no kernel
    launch), gives autograd's grads of the plain forward, and computes no
    weight grads when the weights are constants."""
    shape = (3, 8, 32)
    x, w, b, dy = _inputs(shape, 1)
    counts = lambda: (k5.layer_norm_tanh_forward.launches, k5.layer_norm_tanh_backward.launches,
                      k5.layer_norm_tanh_backward.colsum_launches)
    before = counts()
    xt = torch.tensor(x, requires_grad=True)
    wt, bt = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    y = k5.layer_norm_tanh(xt, wt, bt)
    (y * torch.from_numpy(dy)).sum().backward()
    x2 = torch.tensor(x, requires_grad=True)
    w2, b2 = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    ref = torch.tanh(torch.nn.functional.layer_norm(x2, (32,), w2, b2, eps=1e-6))
    (ref * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(y, ref, atol=2e-6, rtol=0)
    for a, r in ((xt, x2), (wt, w2), (bt, b2)):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-5)
    assert counts() == before

    x3 = torch.tensor(x, requires_grad=True)
    wc, bc = torch.tensor(w), torch.tensor(b)  # constants: only dx is needed
    (k5.layer_norm_tanh(x3, wc, bc) * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(x3.grad, xt.grad, atol=0, rtol=0)
    with pytest.raises(ValueError):
        k5.layer_norm_tanh(torch.tensor(x).transpose(0, 1), wt, bt)
    with pytest.raises(ValueError):
        k5.layer_norm_tanh_forward(torch.tensor(x).reshape(-1, 32).double(), wt, bt)


@pytest.mark.cuda
def test_torch_layer_norm_tanh_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and triton: the kernel has no CPU mode")
    for shape in [(10, 256, 256), (2048, 256), (5, 33, 32)]:
        x, w, b, dy = (torch.tensor(a, device="cuda") for a in _inputs(shape, 2))
        d = shape[-1]
        fwd = k5.layer_norm_tanh_forward.launches
        y, mean, rstd = k5.layer_norm_tanh_forward(x.reshape(-1, d), w, b)
        assert k5.layer_norm_tanh_forward.launches == fwd + 1
        py, pmean, prstd = k5.layer_norm_tanh_forward_plain(x.reshape(-1, d), w, b)
        torch.testing.assert_close(y, py, atol=1e-5, rtol=0)
        bwd = (k5.layer_norm_tanh_backward.launches, k5.layer_norm_tanh_backward.colsum_launches)
        dx, dw, db = k5.layer_norm_tanh_backward(dy.reshape(-1, d), x.reshape(-1, d), w, mean,
                                                 rstd, y)
        assert (k5.layer_norm_tanh_backward.launches,
                k5.layer_norm_tanh_backward.colsum_launches) == (bwd[0] + 1, bwd[1] + 1)
        pdx, pdw, pdb = k5.layer_norm_tanh_backward_plain(dy.reshape(-1, d), x.reshape(-1, d), w,
                                                          pmean, prstd, py)
        torch.testing.assert_close(dx, pdx, atol=1e-4, rtol=0)
        g = dy.reshape(-1, d) * (1 - py * py)
        x_hat = (x.reshape(-1, d) - pmean[:, None]) * prstd[:, None]
        assert (dw - pdw).abs().max() <= 1e-5 * (g * x_hat).abs().sum(0).max()
        assert (db - pdb).abs().max() <= 1e-5 * g.abs().sum(0).max()
