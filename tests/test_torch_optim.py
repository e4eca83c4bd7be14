"""The port's optimizer and train state against serl_tpu's (optax), on the CPU.

Each case runs the JAX optimizer (serl_tpu.common.optimizers.make_optimizer)
and the port's on the same params and the same numpy gradients for several
steps, some of them with no gradient (zeros in optax, `grads=None` in the
port: a group left out of an SAC update). Params, Adam moments and the
learning rate agree to float32 rounding: params to rtol 1e-6 (atol 1e-7;
they are ~1 and move by ~1e-2 a step), Adam moments to rtol 1e-5 (atol
1e-8: ten steps of rounding, and the clip's global norm summed in another
order scales every clipped gradient by a factor that differs in its last
bits); the lr schedule is evaluated in float32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serl_tpu.common.optimizers import make_optimizer as jax_make_optimizer
from serl_tpu.common.optimizers import optimizer_lr as jax_optimizer_lr
from serl_tpu.common.train_state import TrainState as JaxTrainState
from serl_tpu_torch.common.optimizers import make_optimizer, optimizer_lr
from serl_tpu_torch.common.train_state import TrainState

CASES = {
    "warmup": dict(learning_rate=1e-2, warmup_steps=4),
    "constant": dict(learning_rate=3e-3),
    "clip": dict(learning_rate=1e-2, clip_grad_norm=0.5),
    "weight_decay": dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2),
    "cosine": dict(learning_rate=1e-2, warmup_steps=3, cosine_decay_steps=9),
}
ZERO_STEPS = (2, 5)  # steps taken with no gradient


def _params(rng):
    return [rng.normal(size=(3, 5)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_make_optimizer_matches_optax(name):
    kwargs = CASES[name]
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jtx = jax_make_optimizer(**kwargs)
    jp = [jnp.asarray(p) for p in p0]
    jstate = jtx.init(jp)
    tx = make_optimizer(**kwargs)
    tp = [torch.tensor(p) for p in p0]
    state = tx.init(tp)
    assert optimizer_lr(state) == pytest.approx(float(jax_optimizer_lr(jstate)), rel=1e-6)
    for step in range(10):
        grads = [rng.normal(size=p.shape).astype(np.float32) * 2.0 for p in p0]
        if step in ZERO_STEPS:
            jg = [jnp.zeros_like(p) for p in jp]
            state = tx.step(tp, None, state)
        else:
            jg = [jnp.asarray(g) for g in grads]
            state = tx.step(tp, [torch.tensor(g) for g in grads], state)
        updates, jstate = jtx.update(jg, jstate, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        adam = next(s for s in jstate if hasattr(s, "mu"))
        for a, b in zip(state.mu + state.nu, list(adam.mu) + list(adam.nu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-8)
        assert state.count == int(adam.count) == step + 1
        assert optimizer_lr(state) == pytest.approx(float(jax_optimizer_lr(jstate)), rel=1e-6,
                                                    abs=1e-12)
    if "warmup_steps" in kwargs:  # the first step's lr is the schedule at count 0
        assert make_optimizer(**kwargs).schedule(0) == 0.0


def test_torch_zero_grad_step_still_moves_params():
    """The JAX package's quirk: a group left out of an update steps with zero
    gradients, and Adam's momentum keeps moving its params."""
    tx = make_optimizer(learning_rate=0.1)
    p = [torch.ones(3)]
    state = tx.step(p, [torch.tensor([1.0, -2.0, 0.0])], tx.init(p))
    before = p[0].clone()
    state = tx.step(p, None, state)
    assert state.count == 2
    assert (p[0][:2] - before[:2]).abs().min() > 1e-3 and p[0][2] == before[2]


def test_torch_train_state_matches_jax():
    """apply_loss_fns: every group's loss at the pre-step params, grads only
    w.r.t. its own group, a None loss steps with zero grads; polyak targets."""
    rng = np.random.default_rng(1)
    a0, b0 = rng.normal(size=(4,)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)

    def jloss_a(params, _):
        return jnp.sum(params["a"] * params["b"]) ** 2, {}

    def jloss_b(params, _):
        return jnp.sum((params["b"] - params["a"]) ** 2), {}

    txs = {"a": jax_make_optimizer(learning_rate=0.05), "b": jax_make_optimizer(learning_rate=0.05)}
    jstate = JaxTrainState.create(params={"a": jnp.asarray(a0), "b": jnp.asarray(b0)}, txs=txs,
                                  target_groups=("b",))
    a, b = torch.tensor(a0, requires_grad=True), torch.tensor(b0, requires_grad=True)
    state = TrainState({"a": [a], "b": [b]}, {"a": make_optimizer(learning_rate=0.05),
                                             "b": make_optimizer(learning_rate=0.05)},
                       target_groups=("b",))
    for step in range(4):
        skip_b = step == 2
        jfns = {"a": jloss_a, "b": (lambda p, _: (jnp.zeros(()), {})) if skip_b else jloss_b}
        jstate, _ = jstate.apply_loss_fns(jfns)
        jstate = jstate.target_update(0.3)
        fns = {"a": lambda: ((a * b).sum() ** 2, {}),
               "b": None if skip_b else (lambda: (((b - a) ** 2).sum(), {}))}
        infos = state.apply_loss_fns(fns)
        state.target_update(0.3)
        assert set(infos) == {"a", "b"}
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(jstate.params["a"]), rtol=1e-6)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(jstate.params["b"]), rtol=1e-6)
        np.testing.assert_allclose(state.target_params["b"][0].numpy(),
                                   np.asarray(jstate.target_params["b"]), rtol=1e-6)
    assert state.step == int(jstate.step) == 4
    assert a.grad is None and b.grad is None  # autograd.grad, never .backward()
