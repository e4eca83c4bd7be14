"""Workload configuration: one dataclass describes a workload end to end
(env, agent, loop cadence, RLPD, interventions, run control), with the
canonical presets.

The port's copy of `serl_tpu/training/config.py`: the same fields, presets
and command-line surface. `loop_overrides()` feeds `training/loop.py`'s
LoopConfig and `runner_kwargs()` `training/runner.py::run_fused`, the
checkpoint fields (directory, period, pause file, resume) included, and
`trainer_config()` the two-process mode's transport
(`distributed/transport.py`). Presets of task envs that are not ported yet
exist as data; what they need raises where it is reached.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class WorkloadConfig:
    # workload identity
    name: str = "state_sim"
    algo: str = "sac"  # sac | drq | bc
    task: str = "pick_cube"  # pick_cube | peg_insert | pcb_insert | cable_route | bin_fwbw

    # env
    image_obs: bool = False
    image_size: int = 128
    image_keys: Tuple[str, ...] = ("front", "wrist")

    # agent (reference launcher.py:50-116 defaults)
    encoder_type: str = "small"  # small | resnet | resnet50 | resnet-pretrained
    discount: float = 0.99
    critic_ensemble_size: int = 10
    critic_subsample_size: int = 2
    temperature_init: float = 1e-2

    # loop cadence (fused mode) / learner cadence (async mode)
    num_envs: int = 128
    batch_size: int = 256
    utd_ratio: int = 8  # reference critic_actor_ratio
    updates_per_iter: int = 1
    training_starts: int = 1000
    random_steps: int = 1000
    buffer_capacity: int = 200_000
    demo_fraction: float = 0.0  # 0.5 = RLPD 50/50
    num_demos: int = 20
    intervention_prob: float = 0.0
    intervention_mode: str = "step"  # "episode" = expert owns whole episodes
    # linear anneal of intervention_prob to 0 over this many env steps
    intervention_decay_steps: Optional[int] = None

    # transport (async mode; reference launcher.py:171-177)
    ip: str = "127.0.0.1"
    port: int = 5488
    steps_per_update: int = 30  # actor flush cadence (run_actor.sh)
    publish_period: int = 1  # learner param broadcast cadence

    # run control
    seed: int = 0
    total_env_steps: int = 500_000
    chunk_iters: int = 100
    eval_period_chunks: int = 5
    eval_episodes: int = 32
    checkpoint_dir: Optional[str] = None
    checkpoint_period_chunks: int = 50
    success_stop: Optional[float] = None
    pause_file: Optional[str] = None
    resume: bool = False
    debug: bool = False

    # ------------------------------------------------------------------ #

    def loop_overrides(self) -> dict:
        """Fields consumed by training.loop.LoopConfig."""
        return dict(
            num_envs=self.num_envs,
            batch_size=self.batch_size,
            utd_ratio=self.utd_ratio,
            updates_per_iter=self.updates_per_iter,
            training_starts=self.training_starts,
            random_steps=self.random_steps,
            buffer_capacity=self.buffer_capacity,
            demo_fraction=self.demo_fraction,
            intervention_prob=self.intervention_prob,
            intervention_mode=self.intervention_mode,
            intervention_decay_steps=self.intervention_decay_steps,
        )

    def trainer_config(self):
        """Transport config for the two-process async mode (reference
        make_trainer_config, utils/launcher.py:171-177)."""
        from serl_tpu_torch.distributed.transport import TrainerConfig

        return TrainerConfig(port_number=self.port, broadcast_port=self.port + 1)

    def runner_kwargs(self) -> dict:
        """Fields consumed by training.runner.run_fused."""
        return dict(
            total_env_steps=self.total_env_steps,
            chunk_iters=self.chunk_iters,
            eval_period_chunks=self.eval_period_chunks,
            eval_episodes=self.eval_episodes,
            seed=self.seed,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_period_chunks=self.checkpoint_period_chunks,
            success_stop=self.success_stop,
            pause_file=self.pause_file,
            resume=self.resume,
        )

    @classmethod
    def preset(cls, name: str, **overrides) -> "WorkloadConfig":
        cfg = dataclasses.replace(PRESETS[name], **overrides)
        return cfg

    @classmethod
    def add_args(cls, parser: argparse.ArgumentParser, preset: str = "state_sim"):
        base = PRESETS[preset]
        parser.add_argument("--preset", default=preset, choices=sorted(PRESETS))
        for f in dataclasses.fields(cls):
            if f.name in ("name", "image_keys"):
                continue
            default = getattr(base, f.name)
            arg = f"--{f.name}"
            if f.type in ("bool", bool) or isinstance(default, bool):
                parser.add_argument(
                    arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=default, metavar="BOOL",
                )
            elif default is None:
                kind = {"checkpoint_dir": str, "pause_file": str,
                        "success_stop": float}.get(f.name, str)
                parser.add_argument(arg, type=kind, default=None)
            else:
                parser.add_argument(arg, type=type(default), default=default)
        return parser

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "WorkloadConfig":
        """The chosen preset with every field that `args` carries: the parser
        was built from that preset, so an untouched argument keeps its value."""
        base = PRESETS[getattr(args, "preset", "state_sim")]
        overrides = {f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
                     if hasattr(args, f.name)}
        return dataclasses.replace(base, **overrides)


PRESETS = {
    # reference examples/async_sac_state_sim (run_learner.sh / run_actor.sh);
    # num_envs/updates_per_iter are the PROVEN solving recipe
    # (results/sac_state_rlpd_v5e.log: 32 envs, utd 8 x4 per sweep)
    "state_sim": WorkloadConfig(num_envs=32, updates_per_iter=4),
    # reference examples/async_drq_sim (batch 256, critic:actor 4,
    # discount 0.96, mem-efficient pixel buffer)
    "drq_sim": WorkloadConfig(
        name="drq_sim",
        algo="drq",
        image_obs=True,
        discount=0.96,
        num_envs=16,
        utd_ratio=4,
        updates_per_iter=2,
        buffer_capacity=50_000,
        total_env_steps=200_000,
    ),
    # reference examples/async_drq_sim + 20 demos (RLPD)
    "drq_rlpd": WorkloadConfig(
        name="drq_rlpd",
        algo="drq",
        image_obs=True,
        discount=0.96,
        num_envs=16,
        utd_ratio=4,
        updates_per_iter=2,
        buffer_capacity=50_000,
        demo_fraction=0.5,
        total_env_steps=200_000,
    ),
    # reference examples/async_peg_insert_drq (sparse reward + interventions)
    # — the PROVEN recipe (results/peg_insert_rlpd_v5e.log): 20 auto-reset
    # expert demo streams, 50/50 RLPD, expert owns whole episodes with
    # probability 0.5 annealed to 0 over 100k steps, discount 0.97
    "peg_insert": WorkloadConfig(
        name="peg_insert",
        algo="sac",
        task="peg_insert",
        discount=0.97,
        num_envs=16,
        utd_ratio=4,
        demo_fraction=0.5,
        intervention_prob=0.5,
        intervention_mode="episode",
        intervention_decay_steps=100_000,
        total_env_steps=200_000,
        success_stop=0.9,
    ),
    # reference examples/async_cable_route_drq (E5): reward from a trained
    # classifier on the front camera, DrQ on pixels
    "cable_route": WorkloadConfig(
        name="cable_route",
        algo="drq",
        task="cable_route",
        image_obs=True,
        image_size=64,
        discount=0.96,
        num_envs=16,
        utd_ratio=4,
        updates_per_iter=2,
        buffer_capacity=50_000,
        demo_fraction=0.5,
        intervention_prob=0.3,
        intervention_mode="episode",
        total_env_steps=60_000,
    ),
    # reference examples/async_bin_relocation_fwbw_drq (dual policies)
    "fwbw_bin": WorkloadConfig(
        name="fwbw_bin",
        algo="sac",
        task="bin_fwbw",
        num_envs=64,
        utd_ratio=4,
        total_env_steps=200_000,
    ),
}
