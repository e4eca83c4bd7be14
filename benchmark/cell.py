"""The system under test: the port's fused DrQ loop, built from a cell's files, set up and timed.

The loop is `serl_tpu_torch/training/launcher.py::make_drq_sim_experiment`'s
`run_chunk` over `PandaPickCubeEnv`, the pixel `ReplayBuffer` and the DrQ
agent. The benchmark makes every trained weight on the card from the seed
(one `torch.rand` call, scaled per tensor: lecun-uniform kernels, zero
biases, LayerNorm scale 1) and writes it into the agent and its target; the
frozen ResNet-10 is the program's graft of the committed pickle. Set-up
fills the ring to capacity: the loop's random-action steps, then the
seed-made rows of `fill.py`, then the steps up to the checked calls. A
traffic mix with `"learner": false` gives the loop a `training_starts` that
no ring reaches, so its learner never runs: set-up then takes the random
sweeps and the policy's first step, and no learning call is checked.

`Probe` wraps the bound methods of the instances built here, never the
program's code: during set-up it copies to the host what the check reads
(the ring's inserts, the checked calls' batches, the draws the program made
for them, their losses and first Adam moments, the parameters after them,
the policy's first actions); during a traced window it records the
"bench.<layer>" spans.
"""

from __future__ import annotations

import gc
import hashlib
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import fill as fills
from benchmark.reference.drq import B1


def sub_seed(seed: int, salt: str) -> int:
    """A 63-bit seed for one use of the run's `--seed` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


NEVER = 1 << 62  # a `training_starts` above any ring's rows and any window's env steps


def learns(traffic: Dict) -> bool:
    """Whether the mix runs the learner (`"learner": false` turns it off)."""
    return traffic.get("learner", True)


def build(config: Dict, traffic: Dict, seed: int, device: torch.device):
    """The program's experiment at the cell's sizes: (env, agent, rb, init_fn, run_chunk)."""
    from serl_tpu_torch.training.launcher import make_drq_sim_experiment

    learner = ({"updates_per_iter": traffic["updates_per_iter"],
                "training_starts": traffic["training_starts"]} if learns(traffic)
               else {"training_starts": NEVER})
    env, agent, rb, loop_config, init_fn, run_chunk = make_drq_sim_experiment(
        seed=sub_seed(seed, "program"), encoder_type=config["encoder_type"],
        image_size=config["image_size"], device=device, num_envs=traffic["num_envs"],
        batch_size=traffic["batch_size"], utd_ratio=traffic["utd_ratio"],
        random_steps=traffic["random_steps"], buffer_capacity=traffic["buffer_capacity"],
        **learner)
    c = agent.config
    stated = {"discount": config["discount"], "soft_target_update_rate": config["soft_target_update_rate"],
              "target_entropy": config["target_entropy"],
              "critic_ensemble_size": config["critic_ensemble_size"],
              "critic_subsample_size": config["critic_subsample_size"],
              "image_keys": tuple(config["image_keys"])}
    built = {k: getattr(c, k) for k in stated}
    if built != stated:
        raise RuntimeError(f"the program's agent is not the configuration: {built} != {stated}")
    return env, agent, rb, loop_config, init_fn, run_chunk


def _fan_in(name: str, p: torch.Tensor) -> int:
    if name.endswith("pool.embeddings.kernel"):  # (h, w, c, f)
        return p.shape[0] * p.shape[1] * p.shape[2]
    if p.dim() == 4:  # (out, in, kh, kw)
        return p.shape[1] * p.shape[2] * p.shape[3]
    return p.shape[1]  # nn.Linear (out, in) and ensemble kernels (E, in, out)


def _is_norm_scale(name: str, p: torch.Tensor) -> bool:
    """A normalisation's scale: the one-dimensional "weight"s (a Dense's or
    a convolution's has two or more dimensions)."""
    return name.endswith(".weight") and p.dim() == 1


def make_weights(agent, config: Dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Write the seed's weights into every trained tensor of the agent and of
    its target critic; returns {name: a copy} for the reference."""
    named = [(n, p) for n, p in agent.named_parameters() if "pretrained_encoder" not in n]
    kernels = [(n, p) for n, p in named
               if n != "temperature_raw" and not n.endswith("bias") and not _is_norm_scale(n, p)]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(p.numel() for _, p in kernels), generator=g, device=device) * 2.0 - 1.0
    values, at = {}, 0
    for n, p in kernels:
        values[n] = u[at:at + p.numel()].view(p.shape) * math.sqrt(3.0 / _fan_in(n, p))
        at += p.numel()
    raw = math.log(math.expm1(config["temperature_init"]))
    for n, p in named:
        if n == "temperature_raw":
            values[n] = torch.full_like(p, raw)
        elif n not in values:
            values[n] = torch.ones_like(p) if _is_norm_scale(n, p) else torch.zeros_like(p)
    index = {id(p): i for i, p in enumerate(agent.state.params["critic"])}
    with torch.no_grad():
        for n, p in named:
            p.copy_(values[n])
            if id(p) in index:
                agent.state.target_params["critic"][index[id(p)]].copy_(values[n])
    return {n: v.clone() for n, v in values.items()}


class Probe:
    """Wraps the bound methods of the agent, env and ring that the loop calls."""

    SPANS = (("agent", "update_high_utd", "bench.learner"), ("agent", "sample_actions", "bench.policy"),
             ("env", "step_auto_reset", "bench.env"), ("rb", "insert", "bench.replay"),
             ("rb", "sample", "bench.replay"))

    def __init__(self, agent, env, rb, traffic: Dict, device):
        self.objs = {"agent": agent, "env": env, "rb": rb}
        self.device = device
        self.checked = traffic["checked_updates"]
        self.per_call = traffic["utd_ratio"] + 1
        self.names = {id(p): n for n, p in agent.named_parameters()}
        self.inserts: List = []  # (slot, transitions, ep_ids) of the loop's inserts
        self.fill: Optional[fills.Fill] = None
        self.filling = False
        self.shapes = None  # the ring's data tree, as meta tensors
        self.calls: List[Dict] = []  # per checked call: batch, the program's draws
        self.losses: List[Dict[str, float]] = []  # per update() of the checked calls
        self.first_moments: Dict[str, torch.Tensor] = {}
        self.params_after: Optional[Dict[str, torch.Tensor]] = None
        self.policy: Optional[Dict] = None
        self.env_checked: set = {0}  # the env steps copied for the check (set-up adds more)
        self.env_records: List[Dict] = []
        self.n_steps = 0
        self._xy = None
        self.n_calls = 0
        self.n_updates = 0
        self.installed: List = []

    # -- the wrappers

    def _group_moments(self, group: str) -> Dict[str, torch.Tensor]:
        agent = self.objs["agent"]
        return {self.names[id(p)]: (m / (1.0 - B1)).cpu()
                for p, m in zip(agent.state.params[group], agent.state.opt_states[group].mu)
                if id(p) in self.names}

    def capture(self) -> None:
        agent, rb = self.objs["agent"], self.objs["rb"]
        updates = agent.update_high_utd
        update = agent.update
        sample_actions = agent.sample_actions
        insert = rb.insert

        def update_high_utd(batch, *, utd_ratio, draws=None, generator=None):
            self.n_calls += 1
            if self.n_calls > self.checked:
                return updates(batch, utd_ratio=utd_ratio, draws=draws, generator=generator)
            made = []

            def recorded(*args, **kw):
                made.append(drq_draws(*args, **kw))
                return made[-1]

            drq_draws = agent.drq_draws
            agent.drq_draws = recorded
            try:
                out = updates(batch, utd_ratio=utd_ratio, draws=draws, generator=generator)
            finally:
                del agent.drq_draws
            self.calls.append({"batch": _cpu(batch), "draws": _cpu(draws if draws is not None
                                                                     else made[0])})
            if self.n_calls == self.checked:
                self.params_after = {n: _cpu(p) for n, p in agent.named_parameters()
                                     if "pretrained_encoder" not in n}
            return out

        def update_one(batch, **kw):
            out = update(batch, **kw)
            self.n_updates += 1
            if self.n_updates <= self.checked * self.per_call:
                self.losses.append({f"{group}.{k}": float(v) for group, info in out[1].items()
                                    if isinstance(info, dict)
                                    for k, v in info.items() if k.endswith("_loss")})
            if self.n_updates == 1:
                self.first_moments.update(self._group_moments("critic"))
            if self.n_updates == self.per_call:
                self.first_moments.update(self._group_moments("actor"))
                self.first_moments.update(self._group_moments("temperature"))
            return out

        def act(observations, **kw):
            out = sample_actions(observations, **kw)
            if self.policy is None and kw.get("noise") is not None:
                self.policy = {"obs": _cpu(observations), "noise": _cpu(kw["noise"]),
                               "actions": _cpu(out), "after_calls": self.n_calls}
            return out

        def insert_one(state, transitions, ep_ids):
            if self.n_calls < self.checked and not self.filling:
                self.inserts.append((state.insert_slot, _cpu(transitions), _cpu(ep_ids)))
            return insert(state, transitions, ep_ids)

        self._set("agent", "update_high_utd", update_high_utd)
        self._set("agent", "update", update_one)
        self._set("agent", "sample_actions", act)
        self._set("rb", "insert", insert_one)
        self.watch_env()

    def watch_env(self) -> None:
        """Wrap the env's reset, its reset draws and its step: the reset and
        the steps that `env_checked` numbers are copied on the card, with
        their inputs and the reset positions drawn in them, for the check."""
        env = self.objs["env"]
        draw, reset, step = env.sample_reset_xy, env.reset, env.step_auto_reset

        def sample_reset_xy(*args, **kw):
            self._xy = draw(*args, **kw)
            return self._xy

        def reset_all(*args, **kw):
            state, obs = reset(*args, **kw)
            self.env_records.append({"kind": "reset", "step": -1, "xy": self._xy.clone(),
                                     "after": _env_state(state), "obs": _env_obs(obs)})
            return state, obs

        def step_auto_reset(state, action, **kw):
            i = self.n_steps
            self.n_steps += 1
            out = step(state, action, **kw)
            if i in self.env_checked:
                self.env_records.append({
                    "kind": "step", "step": i, "before": _env_state(state), "action": action.clone(),
                    "xy": self._xy.clone(), "after": _env_state(out[0]), "obs": _env_obs(out[1]),
                    "reward": out[2].clone(), "done": out[3].clone(),
                    "success": out[4]["success"].clone()})
            return out

        self._set("env", "sample_reset_xy", sample_reset_xy)
        self._set("env", "reset", reset_all)
        self._set("env", "step_auto_reset", step_auto_reset)

    def spans(self, record) -> None:
        """Open `record(span)` (a `trace.Spans`) around each layer's call."""
        for obj, method, span in self.SPANS:
            fn = getattr(self.objs[obj], method)

            def wrapped(*args, _fn=fn, _span=span, **kw):
                with record(_span):
                    return _fn(*args, **kw)

            self._set(obj, method, wrapped)

    def _set(self, obj: str, method: str, fn) -> None:
        setattr(self.objs[obj], method, fn)
        self.installed.append((obj, method))

    def remove(self) -> None:
        for obj, method in set(self.installed):
            delattr(self.objs[obj], method)
        self.installed = []


def _env_state(state) -> Dict[str, torch.Tensor]:
    out = {k: v.clone() for k, v in state.physics._asdict().items()}
    out.update(t=state.t.clone(), z_init=state.z_init.clone(), ep_id=state.ep_id.clone())
    return out


def _env_obs(obs) -> Dict[str, torch.Tensor]:
    state = obs["state"]
    out = {"state": torch.cat([state[k] for k in sorted(state)], -1).clone()}
    out.update({k: v.clone() for k, v in obs.get("images", {}).items()})
    return out


def set_up(agent, env, rb, init_fn, run_chunk, traffic: Dict, seed: int, probe: Probe):
    """Run the loop's random-action steps, fill the ring with seed-made rows
    up to the steps of the checked calls, which make it full, run those,
    then warm up: returns the carry. With the learner off: the random
    sweeps and the policy's first step, then the warm-up."""
    n = traffic["num_envs"]
    g = torch.Generator(device=probe.device).manual_seed(sub_seed(seed, "loop"))
    if not learns(traffic):
        first_policy = -(-traffic["random_steps"] // n)
        probe.env_checked |= {first_policy, env.time_limit_steps - 1, env.time_limit_steps}
        carry, _ = run_chunk(init_fn(agent, g), first_policy + 1)
        carry, _ = run_chunk(carry, traffic["warmup_iters"])
        return carry
    threshold = -(-max(traffic["training_starts"], traffic["batch_size"] * traffic["utd_ratio"]) // n)
    first_learning = threshold - 1  # the iteration whose insert reaches the threshold
    first_policy = -(-traffic["random_steps"] // n)
    checked_end = max(first_learning + -(-traffic["checked_updates"] // traffic["updates_per_iter"]),
                      first_policy + 1)
    episode = env.time_limit_steps
    probe.env_checked |= {first_policy, checked_end - 1, episode - 1, episode}
    carry = init_fn(agent, g)
    carry, _ = run_chunk(carry, first_learning)
    state = carry.rb_state
    slots = state.ep_id.shape[0]
    probe.fill = fills.Fill(seed, state.insert_slot,
                            slots - state.insert_slot - (checked_end - first_learning), n,
                            env.time_limit_steps)
    probe.shapes = _meta(state.data)
    probe.filling = True
    fills.write(rb, state, probe.fill)
    probe.filling = False
    carry, _ = run_chunk(carry, checked_end - first_learning)
    carry, _ = run_chunk(carry, traffic["warmup_iters"])
    return carry


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def window(run_chunk, carry, seconds: float, chunk_iters: int, learner: bool = True):
    """Run chunks until `seconds` have passed on the host clock, then end on
    a device-to-host read: (carry, iterations, seconds, per-iteration losses
    (with the learner off, the reward means), each chunk's host seconds)."""
    keys = ("critic_loss", "actor_loss") if learner else ("reward_mean",)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    losses, ends, iters = [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        carry, metrics = run_chunk(carry, chunk_iters)
        iters += chunk_iters
        losses.append(torch.stack([metrics[k] for k in keys], 1))
        ends.append(time.perf_counter())
    losses[-1][-1, 0].item()  # waits for all the work enqueued
    elapsed = time.perf_counter() - t0
    chunks = [b - a for a, b in zip([t0] + ends, ends)]
    return carry, iters, elapsed, torch.cat(losses), chunks


def refill(rb, run_chunk, carry) -> Tuple[object, Dict]:
    """After the window: run the loop until it has written every slot of the
    ring again, copying each insert into a shadow of the ring's data (and
    the episode ids it was given) by slot, which the check reads the ring
    back against (`check.readback`): (carry, shadow)."""
    state = carry.rb_state
    shadow = {**{k: _like(v) for k, v in state.data.items()}, "ep_id": torch.empty_like(state.ep_id)}
    insert = rb.insert

    def insert_one(state, transitions, ep_ids):
        slot = state.insert_slot
        for k in state.data:
            _copy_into(shadow[k], slot, transitions[k])
        shadow["ep_id"][slot] = ep_ids
        return insert(state, transitions, ep_ids)

    rb.insert = insert_one
    try:
        carry, _ = run_chunk(carry, state.ep_id.shape[0])
    finally:
        del rb.insert
    return carry, shadow


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def _copy_into(tree, slot: int, value) -> None:
    if isinstance(tree, dict):
        for k in tree:
            _copy_into(tree[k], slot, value[k])
    else:
        tree[slot] = value
