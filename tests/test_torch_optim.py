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
from serl_tpu_torch.common.optimizers import (B1, B2, EPS, OptState, _clip_by_global_norm,
                                              device_scalars, make_optimizer, optimizer_lr)
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


# Per-step scalars on the device: a CUDA graph of `SACAgent.update` replays one
# captured step, so every step reads its lr and bias corrections from a device
# tensor (`TrainState.step_scalars`, packed into one tensor) instead of host
# floats (agents/graphs.py). On the CPU that has to give the bits of the
# host-float step below.
DEVICE_SCALAR_CASES = {
    "warmup": dict(learning_rate=3e-4, warmup_steps=2000),
    "warmup_then_cosine": dict(learning_rate=3e-4, warmup_steps=2000, cosine_decay_steps=2060),
    "clip_and_weight_decay": dict(learning_rate=3e-4, warmup_steps=2000, clip_grad_norm=0.5,
                                  weight_decay=0.01),
}


@torch.no_grad()
def _host_float_step(tx, params, grads, state):
    """One step with lr and the bias corrections as Python floats, the
    params moved by `_foreach_add_(alpha=-lr)`: the reference arithmetic."""
    lr, bc1, bc2 = tx.scalars(state.count)
    mu, nu = state.mu, state.nu
    if grads is not None and tx.clip_grad_norm is not None:
        grads = _clip_by_global_norm(list(grads), tx.clip_grad_norm)
    torch._foreach_mul_(mu, B1)
    torch._foreach_mul_(nu, B2)
    if grads is not None:
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    if tx.weight_decay is not None:
        torch._foreach_add_(updates, params, alpha=tx.weight_decay)
    torch._foreach_add_(params, updates, alpha=-lr)
    return OptState(state.count + 1, mu, nu, lr)


@pytest.mark.parametrize("name", sorted(DEVICE_SCALAR_CASES))
def test_torch_step_on_packed_scalars_is_the_float_step_bit_for_bit(name):
    """Over 2,100 steps across the 2,000-step warmup (and a cosine decay to 0
    past it), with zero-gradient steps of one group: `apply_gradients`, and a
    step given the packed (groups, 3) tensor with its host state moved by
    `advance` (what a graph's replay does), give the host-float step's
    params, Adam moments, counts, learning rates and step bit for bit."""
    kwargs = DEVICE_SCALAR_CASES[name]
    g = torch.Generator().manual_seed(7)
    p0 = {"a": [torch.randn(64, 33, generator=g), torch.randn(7, generator=g)],
          "b": [torch.randn(5, 3, generator=g)]}

    def state():
        return TrainState({k: [p.clone() for p in ps] for k, ps in p0.items()},
                          {k: make_optimizer(**kwargs) for k in p0})

    ref, eager, packed = state(), state(), state()
    for step in range(2100):
        grads = {k: [torch.randn(p.shape, generator=g) for p in ps] for k, ps in p0.items()}
        if step % 7 == 3:
            grads["b"] = None  # a group left out of an update
        for k in p0:
            ref.opt_states[k] = _host_float_step(ref.txs[k], ref.params[k], grads[k],
                                                 ref.opt_states[k])
        eager.apply_gradients(grads)
        rows = packed.step_scalars()
        packed.apply_gradients(grads, device_scalars(list(rows.values()), torch.device("cpu")))
        packed.advance(rows)
        for got_state in (eager, packed):
            for k in p0:
                want, got = ref.opt_states[k], got_state.opt_states[k]
                for a, b in zip(ref.params[k] + want.mu + want.nu,
                                got_state.params[k] + got.mu + got.nu):
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (name, step, k)
                assert (got.count, got.learning_rate) == (want.count, want.learning_rate)
    assert packed.step == eager.step == 2100
    assert ref.opt_states["a"].learning_rate == pytest.approx(
        0.0 if "cosine_decay_steps" in kwargs else 3e-4, abs=1e-9)


def test_torch_sac_update_on_cpu_tensors_never_captures(monkeypatch):
    """CPU tensors take the eager step: no CUDA graph is made, whatever the
    number of steps of one key."""
    from serl_tpu_torch.agents.sac import SACAgent

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was made for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", no_graph)
    g = torch.Generator().manual_seed(0)
    agent = SACAgent.create_states(torch.zeros(1, 6), torch.zeros(1, 3), generator=g,
                                   critic_ensemble_size=4, critic_subsample_size=2,
                                   critic_network_kwargs={"hidden_dims": (16, 16)},
                                   policy_network_kwargs={"hidden_dims": (16, 16)}, device="cpu")
    batch = {"observations": torch.randn(8, 6, generator=g),
             "actions": torch.rand(8, 3, generator=g),
             "next_observations": torch.randn(8, 6, generator=g),
             "rewards": torch.randn(8, generator=g), "masks": torch.ones(8)}
    for _ in range(3):
        agent.update(batch, generator=g)
        agent.update_high_utd(batch, utd_ratio=2, generator=g)
    assert agent.state.step == 3 * 4
    assert (agent.graphs.captures, agent.graphs.replays, agent.graphs.graphs,
            agent.graphs.failed) == (0, 0, {}, {})
