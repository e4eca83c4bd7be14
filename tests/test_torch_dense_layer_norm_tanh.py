"""K5, tanh(LayerNorm(x W + b) * gamma + beta), against flax and jax.grad on the CPU.

The port's plain versions (the kernels' arithmetic in torch, which CPU
tensors take) and the autograd op over them are held, on numpy inputs, to
flax `nn.Dense` or the JAX package's `EnsembleDense` einsum
(serl_tpu/networks/mlp.py:70-83), then `nn.LayerNorm()` and `jnp.tanh`
forward, and to `jax.grad` of a weighted sum of it with respect to x, the
kernel, the bias, the LayerNorm scale and bias, for the three input forms
(one nn.Linear weight; an input shared by the ensemble; one input per
member). The inputs give the Dense output a non-zero row mean and a
variance of ~0.06-0.7, as the networks' first layers do.

Tolerances, each against the largest magnitude of the reference:
  * y: 1e-5 abs. Outputs are in (-1, 1); the two frameworks sum the K
    products of the Dense (up to 580 here) and the D squares of the
    variance in other orders (flax takes E[x^2] - E[x]^2, the port two
    passes), and rstd (up to ~5.6 here) scales that rounding; the largest
    seen is 1.9e-6. LayerNorm's epsilon moves y by 6e-5 to 1e-4 at K = 7 and
    14 between torch's 1e-5 and flax's 1e-6, so a wrong epsilon fails.
  * grads: 5e-6 of the largest |reference|: sums over the rows (dW, the
    biases, gamma, beta) or over the members and D (dx) in another order, of
    values rounded as above; the largest seen is 8.7e-7.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.networks.mlp import EnsembleDense as JaxEnsembleDense
from serl_tpu_torch.networks import dense_layer_norm_tanh as k5
from tests import torch_k5

Y_ATOL, GRAD_REL = 1e-5, 5e-6
E = 3
LEAD = (2, 5)  # leading axes of x: M = 10 rows


def _ln_inputs(shape, seed):
    """LayerNorm-tanh inputs: rows with a non-zero mean, perturbed gamma and beta."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + rng.normal(size=shape[:-1] + (1,))).astype(np.float32)
    w = (1.0 + 0.3 * rng.normal(size=(d,))).astype(np.float32)
    b = (0.2 * rng.normal(size=(d,))).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, w, b, dy


def _dense_inputs(form, k, d, seed):
    """(x, kernel (K, D) or (E, K, D), bias (D,) or (E, D), gamma, beta, dy)."""
    rng = np.random.default_rng(seed)
    x_shape = ((E,) if form == "member" else ()) + LEAD + (k,)
    x = (0.5 * rng.normal(size=x_shape) + 0.5).astype(np.float32)
    members = () if form == "linear" else (E,)
    bound = np.sqrt(6.0 / (k + d))  # xavier-uniform, as the networks' Dense
    kernel = rng.uniform(-bound, bound, size=members + (k, d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=members + (d,))).astype(np.float32)
    gamma = (1.0 + 0.3 * rng.normal(size=(d,))).astype(np.float32)
    beta = (0.2 * rng.normal(size=(d,))).astype(np.float32)
    out = (() if form == "linear" else (E,)) + LEAD + (d,)
    dy = rng.normal(size=out).astype(np.float32)
    return x, kernel, bias, gamma, beta, dy


def _flax_ln_tanh(h, gamma, beta):
    return jnp.tanh(fnn.LayerNorm().apply({"params": {"scale": gamma, "bias": beta}}, h))


def _jax_forward(form, x, kernel, bias, gamma, beta):
    params = {"params": {"kernel": kernel, "bias": bias}}
    if form == "linear":
        h = fnn.Dense(kernel.shape[-1]).apply(params, x)
    else:
        h = JaxEnsembleDense(E, kernel.shape[-1]).apply(params, x,
                                                        member_inputs=form == "member")
    return _flax_ln_tanh(h, gamma, beta)


def _port_args(form, x, kernel, bias, gamma, beta, requires_grad=True):
    """Torch tensors as the port's modules hold them: nn.Linear keeps its
    kernel as a (D, K) weight."""
    arrays = (x, kernel.T.copy() if form == "linear" else kernel, bias, gamma, beta)
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


def _assert_rel(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: err {err:.3g}, max {np.abs(want).max():.3g}"


@pytest.mark.parametrize("shape", [(4, 16, 32), (24, 256)])
def test_torch_dense_layer_norm_tanh_plain_ln_tanh_matches_flax(shape):
    """The plain arithmetic of LayerNorm -> tanh and its backward, through an
    identity Dense (h = x exactly), against flax and jax.grad."""
    x, w, b, dy = _ln_inputs(shape, 0)
    d = shape[-1]
    want = np.asarray(_flax_ln_tanh(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    x3 = torch.from_numpy(x).reshape(1, -1, d)
    eye, zero = torch.eye(d)[None], torch.zeros(1, d)
    y, h, mean, rstd = k5.dense_layer_norm_tanh_forward_plain(x3, eye, zero, torch.from_numpy(w),
                                                              torch.from_numpy(b))
    assert torch.equal(h, x3)
    np.testing.assert_allclose(y.reshape(shape).numpy(), want, atol=2e-6, rtol=0)

    jdx, jdw, jdb = jax.grad(lambda x, w, b: jnp.sum(_flax_ln_tanh(x, w, b) * dy),
                             argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dh, dw, db, dbias = k5.dense_layer_norm_tanh_backward_plain(
        torch.from_numpy(dy).reshape(1, -1, d), y, h, mean, rstd, torch.from_numpy(w))
    np.testing.assert_allclose(dh.reshape(shape).numpy(), np.asarray(jdx), atol=1e-5, rtol=0)
    g = (dy * (1 - want ** 2)).reshape(-1, d)
    x_hat = (x.reshape(-1, d) - mean.numpy()[0, :, None]) * rstd.numpy()[0, :, None]
    assert np.abs(dw.numpy() - np.asarray(jdw)).max() <= 1e-6 * np.abs(g * x_hat).sum(0).max()
    assert np.abs(db.numpy() - np.asarray(jdb)).max() <= 1e-6 * np.abs(g).sum(0).max()
    torch.testing.assert_close(dbias, dh.sum(1), atol=0, rtol=0)
    _, no_dw, no_db, no_dbias = k5.dense_layer_norm_tanh_backward_plain(
        torch.from_numpy(dy).reshape(1, -1, d), y, h, mean, rstd, torch.from_numpy(w),
        need_weight_grads=False)
    assert no_dw is None and no_db is None and no_dbias is None


@pytest.mark.parametrize("form", ["linear", "shared", "member"])
@pytest.mark.parametrize("k,d", [(7, 64), (14, 256), (580, 256)])
def test_torch_dense_layer_norm_tanh_matches_flax_and_jax_grad(form, k, d):
    x, kernel, bias, gamma, beta, dy = _dense_inputs(form, k, d, seed=k + d)
    jargs = [jnp.asarray(a) for a in (x, kernel, bias, gamma, beta)]
    want = np.asarray(_jax_forward(form, *jargs))
    grads = jax.grad(lambda *a: jnp.sum(_jax_forward(form, *a) * dy), argnums=range(5))(*jargs)

    args = _port_args(form, x, kernel, bias, gamma, beta)
    y = k5.dense_layer_norm_tanh(*args, member_inputs=form == "member")
    assert y.shape == want.shape
    np.testing.assert_allclose(y.detach().numpy(), want, atol=Y_ATOL, rtol=0)
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, jg in zip(("x", "kernel", "bias", "gamma", "beta"), args, grads):
        got = t.grad.numpy().T if (name == "kernel" and form == "linear") else t.grad.numpy()
        _assert_rel(got, jg, GRAD_REL, f"{form} K={k} D={d} d{name}")


def test_torch_dense_layer_norm_tanh_dbias_is_per_member():
    """The ensemble's Dense bias gets each member's own sum of dh, and the
    shared LayerNorm's gamma and beta the sum over every member."""
    x, kernel, bias, gamma, beta, dy = _dense_inputs("shared", 14, 64, seed=3)
    x3, w3, b2, _ = k5.member_views(*(torch.from_numpy(a) for a in (x, kernel, bias)), False)
    y, h, mean, rstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, torch.from_numpy(gamma),
                                                              torch.from_numpy(beta))
    dh, dgamma, dbeta, dbias = k5.dense_layer_norm_tanh_backward_plain(
        torch.from_numpy(dy).reshape(y.shape), y, h, mean, rstd, torch.from_numpy(gamma))
    assert dbias.shape == (E, 64)
    for e in range(E):
        torch.testing.assert_close(dbias[e], dh[e].sum(0), atol=0, rtol=0)
    assert (dbias[0] - dbias[1]).abs().max() > 1e-3  # the members' sums differ
    args = _port_args("shared", x, kernel, bias, gamma, beta)
    (k5.dense_layer_norm_tanh(*args) * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(args[2].grad, dbias, atol=0, rtol=0)
    torch.testing.assert_close(args[3].grad, dgamma, atol=0, rtol=0)
    torch.testing.assert_close(args[4].grad, dbeta, atol=0, rtol=0)


@pytest.mark.parametrize("form", ["linear", "shared", "member"])
def test_torch_dense_layer_norm_tanh_autograd_op_on_cpu(form):
    """The autograd op runs the plain versions for CPU tensors (no kernel
    launch), gives autograd's grads of Dense -> F.layer_norm -> tanh, and
    without autograd (no_grad) the same y."""
    x, kernel, bias, gamma, beta, dy = _dense_inputs(form, 14, 64, seed=1)
    counts = lambda: (k5.dense_layer_norm_tanh_forward.launches,
                      k5.dense_layer_norm_tanh_backward.launches)
    before = counts()
    args = _port_args(form, x, kernel, bias, gamma, beta)
    y = k5.dense_layer_norm_tanh(*args, member_inputs=form == "member")
    (y * torch.from_numpy(dy)).sum().backward()
    ref_args = _port_args(form, x, kernel, bias, gamma, beta)
    rx, rk, rb, rg, rbeta = ref_args
    if form == "linear":
        h = torch.nn.functional.linear(rx, rk, rb)
    elif form == "shared":
        h = torch.einsum("...i,eio->e...o", rx, rk) + rb.reshape(E, 1, 1, -1)
    else:
        h = torch.einsum("e...i,eio->e...o", rx, rk) + rb.reshape(E, 1, 1, -1)
    ref = torch.tanh(torch.nn.functional.layer_norm(h, (64,), rg, rbeta, eps=1e-6))
    (ref * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(y, ref, atol=2e-6, rtol=0)
    for a, r in zip(args, ref_args):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        y_ng = k5.dense_layer_norm_tanh(*args, member_inputs=form == "member")
    torch.testing.assert_close(y_ng, y.detach(), atol=0, rtol=0)
    assert counts() == before


def test_torch_dense_layer_norm_tanh_constants_give_dx_only():
    """With the params as constants (the actor loss's pass through the
    critic) only dx flows, and it equals dx of the pass with weight grads."""
    x, kernel, bias, gamma, beta, dy = _dense_inputs("member", 14, 64, seed=2)
    args = _port_args("member", x, kernel, bias, gamma, beta)
    (k5.dense_layer_norm_tanh(*args, member_inputs=True) * torch.from_numpy(dy)).sum().backward()
    xc = torch.tensor(x, requires_grad=True)
    consts = _port_args("member", x, kernel, bias, gamma, beta, requires_grad=False)[1:]
    (k5.dense_layer_norm_tanh(xc, *consts, member_inputs=True)
     * torch.from_numpy(dy)).sum().backward()
    torch.testing.assert_close(xc.grad, args[0].grad, atol=0, rtol=0)
    assert all(c.grad is None for c in consts)


def test_torch_dense_layer_norm_tanh_shape_log_names_each_call():
    """With `shape_log` set, each call adds its (form, E, M, K, D) and each
    backward that signature with (weight grads, dx); unset, nothing is kept."""
    try:
        k5.shape_log = set()
        for form in ("linear", "shared", "member"):
            x, kernel, bias, gamma, beta, dy = _dense_inputs(form, 14, 64, seed=6)
            args = _port_args(form, x, kernel, bias, gamma, beta)
            args[0].requires_grad_(form != "linear")
            if form == "member":
                for a in args[1:]:
                    a.requires_grad_(False)
            y = k5.dense_layer_norm_tanh(*args, member_inputs=form == "member")
            (y * torch.from_numpy(dy)).sum().backward()
            with torch.no_grad():
                k5.dense_layer_norm_tanh(*args, member_inputs=form == "member")
        m = int(np.prod(LEAD))
        assert k5.shape_log == {("linear", 1, m, 14, 64), ("shared", E, m, 14, 64),
                                ("member", E, m, 14, 64), ("linear", 1, m, 14, 64, True, False),
                                ("shared", E, m, 14, 64, True, True),
                                ("member", E, m, 14, 64, False, True)}
    finally:
        k5.shape_log = None
    k5.dense_layer_norm_tanh(*_port_args("linear", *_dense_inputs("linear", 14, 64, seed=6)[:5]))
    assert k5.shape_log is None


def test_torch_dense_layer_norm_tanh_rejects_what_the_kernels_do_not_take():
    x, kernel, bias, gamma, beta, _ = _dense_inputs("shared", 14, 64, seed=4)
    x3, w3, b2, _ = k5.member_views(*(torch.from_numpy(a) for a in (x, kernel, bias)), False)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    with pytest.raises(ValueError, match="no kernel"):
        k5.dense_layer_norm_tanh_forward(x3.to("meta"), w3.to("meta"), b2.to("meta"),
                                         g.to("meta"), b.to("meta"))
    y, h, mean, rstd = k5.dense_layer_norm_tanh_forward(x3, w3, b2, g, b, save=True)
    assert h is not None and k5.dense_layer_norm_tanh_forward(x3, w3, b2, g, b)[1] is None
    with pytest.raises(ValueError, match="no kernel"):
        k5.dense_layer_norm_tanh_backward(*(t.to("meta") for t in (y, y, h, mean, rstd, g)))


@pytest.mark.cuda
def test_torch_dense_layer_norm_tanh_kernels_match_plain_on_card():
    """The kernels against the plain versions under tests/torch_k5.py's rule,
    each launch counted once, the weight-grad sums repeating bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    for form, e, m, k, d in [("shared", 10, 256, 14, 256), ("member", 10, 256, 256, 256),
                             ("linear", 1, 2048, 10, 256), ("linear", 1, 256, 7, 64),
                             ("shared", 10, 256, 580, 256), ("member", 3, 33, 33, 128),
                             # split along K: few row tiles, deep K
                             ("linear", 1, 256, 4096, 256), ("linear", 1, 16, 576, 256),
                             ("shared", 3, 20, 1000, 64)]:
        x, kernel, bias, gamma, beta, dy = torch_k5.inputs(form, e, m, k, d, g, "cuda")
        x3, w3, b2, _ = k5.member_views(x, kernel, bias, form == "member")
        fwd, bwd = (k5.dense_layer_norm_tanh_forward.launches,
                    k5.dense_layer_norm_tanh_backward.launches)
        out = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta, save=True)
        assert not torch_k5.failures(*torch_k5.forward_errors(x3, w3, b2, gamma, beta, *out))
        y_only = k5.dense_layer_norm_tanh_forward(x3, w3, b2, gamma, beta)[0]
        assert torch.equal(y_only, out[0])  # a split K's partials add in a fixed order
        py, ph, pmean, prstd = k5.dense_layer_norm_tanh_forward_plain(x3, w3, b2, gamma, beta)
        grads = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        again = k5.dense_layer_norm_tanh_backward(dy, py, ph, pmean, prstd, gamma)
        assert (k5.dense_layer_norm_tanh_forward.launches,
                k5.dense_layer_norm_tanh_backward.launches) == (fwd + 2, bwd + 2)
        assert not torch_k5.failures(*torch_k5.backward_errors(dy, py, ph, pmean, prstd, gamma,
                                                               *grads))
        for got, rep in zip(grads[1:], again[1:]):
            assert torch.equal(got, rep)  # fixed-order sums repeat bit for bit
