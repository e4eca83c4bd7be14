"""The ranks' side of tests/test_torch_sharding.py: tasks that the spawned
torch.distributed ranks run (this module imports no JAX, so a rank starts
quickly), and the port's small agents both sides build."""

import torch

from serl_tpu_torch.agents.drq import DrQAgent
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.examples.dryrun_multichip import run_program
from serl_tpu_torch.utils.jax_params import load_train_state, train_state_to_jax_layout
from serl_tpu_torch.vision.encoders import SmallEncoder

# tests/test_torch_learner.py's and tests/test_torch_drq.py's small agents
OBS, ACT, H, E, S = 6, 3, 32, 4, 2
DRQ_KEYS, DRQ_FEATURES, DRQ_BOTTLENECK, DRQ_ACT, DRQ_SIZE = ("front", "wrist"), (4, 8, 8, 16), 16, 4, 32
OPT = {"learning_rate": 1e-3}


def agent_kwargs(tanh, discount=0.99, **extra):
    net = {"activations": tanh, "use_layer_norm": True, "hidden_dims": (H, H)}
    return dict(policy_kwargs={"tanh_squash_distribution": True, "std_parameterization": "exp",
                               "std_min": 1e-5, "std_max": 5.0},
                critic_network_kwargs=net, policy_network_kwargs=dict(net), temperature_init=1e-2,
                discount=discount, critic_ensemble_size=E, critic_subsample_size=S,
                actor_optimizer_kwargs=OPT, critic_optimizer_kwargs=OPT,
                temperature_optimizer_kwargs=OPT, **extra)


def tree(fn, t):
    return {k: tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def port_agent(form: str, example_obs=None):
    """The port's agent of a parity case: SAC ("sac", "rlpd", "bc") or DrQ
    on two 32 px cameras ("drq"), weights to be loaded from JAX's."""
    g = torch.Generator().manual_seed(1)
    if form == "drq":
        encs = {k: SmallEncoder(3, DRQ_FEATURES, bottleneck_dim=DRQ_BOTTLENECK) for k in DRQ_KEYS}
        kw = agent_kwargs("tanh", discount=0.96, image_keys=DRQ_KEYS)
        return DrQAgent.create_drq(tree(torch.from_numpy, example_obs), torch.zeros(1, DRQ_ACT),
                                   custom_encoders=encs, generator=g, device="cpu", **kw)
    extra = {"bc_regularization": 0.5} if form == "bc" else {}
    return SACAgent.create_states(torch.zeros(1, OBS), torch.zeros(1, ACT), generator=g,
                                  device="cpu", **agent_kwargs("tanh", **extra))


class UpdateParity:
    """One update_high_utd per case on this rank's block of rows: each case
    holds the form, JAX's learner state, the global stream-major batch
    (numpy; with "rlpd" the online half and the demo half apart), JAX's
    draws and the UTD ratio. Returns per case the learner state in JAX's layout, the
    infos and the collectives it issued."""

    def __init__(self, cases):
        self.cases = cases

    def __call__(self, dp):
        torch.set_num_threads(1)
        out = []
        for case in self.cases:
            agent = port_agent(case["form"], case.get("example_obs"))
            load_train_state(agent, case["state"])
            agent.state.dp = dp
            dp.reset_counts()
            # the rank's block of the global batch: its streams' rows (with
            # "rlpd", of the online half, interleaved with the same rows of
            # the replicated demo half)
            if case["form"] == "rlpd":
                halves = [tree(torch.from_numpy, case[h]) for h in ("online", "demo")]
                rows = dp.share(halves[0]["rewards"].shape[0])
                a, b = (tree(lambda x: x[rows], h) for h in halves)
                batch = {k: torch.stack([a[k], b[k]], 1).reshape((-1,) + a[k].shape[1:])
                         for k in a}
            else:
                full = tree(torch.from_numpy, case["batch"])
                batch = tree(lambda x: x[dp.share(full["rewards"].shape[0])], full)
            _, info = agent.update_high_utd(batch, utd_ratio=case["utd"], draws=case["draws"])
            out.append({"state": train_state_to_jax_layout(agent),
                        "info": tree(lambda v: float(v) if isinstance(v, torch.Tensor) else v, info),
                        "collectives": {k: dict(v) for k, v in dp.counts.items()}})
        return out


class LoopRuns:
    """The programs of cases (c) and (d) on this rank: `run_program`'s
    keywords per run; checks that no ring insert issues a collective."""

    def __init__(self, runs, snapshot_dir):
        self.runs, self.snapshot_dir = runs, snapshot_dir

    def __call__(self, dp):
        from serl_tpu_torch.data.routed_buffer import RoutedReplayBuffer

        torch.set_num_threads(1)
        inserts = []
        originals = {cls: cls.insert for cls in (ReplayBuffer, RoutedReplayBuffer)}

        def counted(cls):
            def insert(self, *a, **kw):
                before = {k: dict(v) for k, v in dp.counts.items()}
                out = originals[cls](self, *a, **kw)
                inserts.append(before == {k: dict(v) for k, v in dp.counts.items()})
                return out
            return insert

        for cls in originals:
            cls.insert = counted(cls)
        try:
            results = [run_program(name, dp, "cpu", dp.world_size, False,
                                   snapshot_dir=self.snapshot_dir, **kw)
                       for name, kw in self.runs]
        finally:
            for cls, fn in originals.items():
                cls.insert = fn
        for r in results:
            r["inserts_without_collectives"] = (len(inserts), all(inserts))
        return results


def merge_snapshots(paths_by_rank):
    """The global view of each rank's snapshot (examples/dryrun_multichip.py's
    `_snapshot`): env rows concatenated, ring streams concatenated (axis 1),
    the replicated agents from rank 0 (and whether every rank's equal rank
    0's bit for bit)."""
    snaps = [torch.load(p, weights_only=False) for p in paths_by_rank]
    env = {k: torch.cat([s["env"][k] for s in snaps]) for k in snaps[0]["env"]}
    rings = {name: {k: torch.cat([s["rings"][name][k] for s in snaps], 1) for k in ring}
             for name, ring in snaps[0]["rings"].items()}
    agents_equal = all(torch.equal(a, b) for s in snaps[1:]
                       for ta, tb in zip(snaps[0]["agents"], s["agents"]) for a, b in zip(ta, tb))
    return {"env": env, "rings": rings, "agents": snaps[0]["agents"],
            "agents_equal": agents_equal}


def field_diffs(xs, ys) -> dict:
    """Per field ({path: tensor} dicts, or lists by position), the max abs
    difference (floats) or the count of unequal entries (integers)."""
    if not isinstance(xs, dict):
        xs, ys = dict(enumerate(xs)), dict(enumerate(ys))
    assert xs.keys() == ys.keys(), set(xs) ^ set(ys)
    out = {}
    for k, x in xs.items():
        y = ys[k]
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        if not x.numel():
            out[k] = 0.0
        elif x.is_floating_point():
            out[k] = float((x.double() - y.double()).abs().max())
        else:
            out[k] = float((x != y).sum())
    return out


def max_abs_diff(xs, ys) -> float:
    return max(field_diffs(xs, ys).values(), default=0.0)


class Tasks:
    """Several tasks on one spawn of the ranks: [task(dp) for task in tasks]."""

    def __init__(self, *tasks):
        self.tasks = tasks

    def __call__(self, dp):
        return [task(dp) for task in self.tasks]


# ---------------------------------------------------------------- the isolated fwbw program


def fwbw_isolated(device, config, dp=None, seed: int = 0):
    """The isolated fwbw program (training/fwbw.py::make_fwbw_loop) at
    `config` (a FwBwConfig): the two bin-task envs, a state ring spec, SAC
    agents from seeds 0 and 1 at the launcher's defaults, the carry built
    at the global size from `seed` and, with `dp`, cut to the rank's share.
    Returns (fw_env, bw_env, rb, agents, carry, run_chunk)."""
    from serl_tpu_torch.distributed.sharding import shard_fwbw_carry
    from serl_tpu_torch.envs.tasks import STATE_OBS_DIM, BinRelocationEnv
    from serl_tpu_torch.training.fwbw import make_fwbw_loop
    from serl_tpu_torch.training.launcher import make_sac_agent, make_state_replay_buffer

    fw_env = BinRelocationEnv(task_id=0, device=device)
    bw_env = BinRelocationEnv(task_id=1, device=device)
    rb = make_state_replay_buffer(capacity=config.buffer_capacity, obs_dim=STATE_OBS_DIM,
                                  action_dim=7, device=device)
    agents = tuple(make_sac_agent(s, obs_dim=STATE_OBS_DIM, action_dim=7, device=device)
                   for s in (0, 1))
    init_fn, run_chunk = make_fwbw_loop(fw_env, bw_env, rb, config, dp=dp)
    carry = init_fn(*agents, seed)
    if dp is not None:
        carry = shard_fwbw_carry(carry, dp)
    return fw_env, bw_env, rb, agents, carry, run_chunk


def fwbw_snapshot(carry, agents) -> dict:
    """CPU copies of both tasks' env rows, obs and statistics rows, both
    rings' fields and both agents' learner state, in `merge_snapshots`'
    layout."""
    from serl_tpu_torch.distributed.sharding import agent_tensors
    from serl_tpu_torch.examples.dryrun_multichip import _named

    def cpu(named):
        return {k: t.detach().cpu().clone() for k, t in named.items()}

    env, rings = {}, {}
    for name in ("fw", "bw"):
        tc = getattr(carry, name)
        env.update(cpu({**_named(tc.env_states, f"/{name}"), **_named(tc.obs, f"/{name}/obs"),
                        f"/{name}/ep_return": tc.ep_return,
                        f"/{name}/intervening": tc.intervening}))
        rings[name] = cpu({**_named(tc.rb_state.data), "/ep_id": tc.rb_state.ep_id})
    return {"env": env, "rings": rings,
            "agents": [[t.detach().cpu().clone() for t in agent_tensors(a)] for a in agents]}


def run_fwbw_isolated(dp, device, config, segments, snapshot_dir=None) -> dict:
    """The isolated program on this rank (or alone, `dp` None) in
    `segments` of iterations; after each, the replicated state's digests
    are checked equal over the ranks and, with `snapshot_dir`, the rank's
    share saved as <dir>/fwbw_isolated_r<rank>_s<segment>.pt. Returns the
    metrics, the kernel launches and the collectives after the carry is
    placed, and the final digest."""
    import os

    from serl_tpu_torch.distributed.sharding import replicated_digests
    from serl_tpu_torch.examples.dryrun_multichip import kernel_launches

    rank = 0 if dp is None else dp.rank
    *_, agents, carry, run_chunk = fwbw_isolated(device, config, dp)
    if dp is not None:
        dp.reset_counts()
    launches0 = kernel_launches()
    history, digest = [], None
    for i, seg in enumerate(segments):
        carry, m = run_chunk(carry, seg)
        history.append(m)
        if dp is not None:
            digests = replicated_digests(dp, agents, carry.rng)
            if len(set(digests)) != 1:
                raise AssertionError(f"fwbw isolated: the ranks' digests differ: {digests}")
            digest = digests[0]
        if snapshot_dir is not None:
            torch.save(fwbw_snapshot(carry, agents),
                       os.path.join(snapshot_dir, f"fwbw_isolated_r{rank}_s{i}.pt"))
    return {"rank": rank, "iters": sum(segments), "env_steps": carry.env_steps,
            "metrics": {k: torch.cat([h[k].reshape(len(h[k]), -1) for h in history]).cpu()
                        for k in history[0]},
            "agent_steps": [a.state.step for a in agents], "digest": digest,
            "launches": {k: v - launches0[k] for k, v in kernel_launches().items()},
            "collectives": {} if dp is None else {k: dict(v) for k, v in dp.counts.items()}}


class FwbwIsolatedRun:
    """A rank's task: `run_fwbw_isolated` on the rank's device."""

    def __init__(self, config, segments, snapshot_dir=None):
        self.config, self.segments, self.snapshot_dir = config, segments, snapshot_dir

    def __call__(self, dp):
        if dp.device.type == "cpu":
            torch.set_num_threads(1)
        return run_fwbw_isolated(dp, dp.device, self.config, self.segments, self.snapshot_dir)
