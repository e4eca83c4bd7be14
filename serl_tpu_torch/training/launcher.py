"""Agent/loop factories with the reference's canonical hyperparameters.

Port of the state and pixel factories of `serl_tpu/training/launcher.py`:
ensemble 10 / subsample 2, temperature 1e-2, tanh activations + LayerNorm
256x256, discount 0.99 (state) / 0.96 (pixels), exp std in [1e-5, 5].
Everything lands on `device`, "cuda" unless the caller passes another.
"""

import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.envs.panda_pick import (
    ACTION_DIM,
    PIXEL_STATE_DIM,
    STATE_OBS_DIM,
    PandaPickCubeEnv,
)

_POLICY_KWARGS = {"tanh_squash_distribution": True, "std_parameterization": "exp",
                  "std_min": 1e-5, "std_max": 5.0}
_NET_KWARGS = {"activations": "tanh", "use_layer_norm": True, "hidden_dims": (256, 256)}


def _round_up(n: int, k: int) -> int:
    """Smallest multiple of k >= n (ring capacity must divide by env count)."""
    return ((n + k - 1) // k) * k


def make_sac_agent(seed: int, obs_dim: int = STATE_OBS_DIM, action_dim: int = ACTION_DIM,
                   discount: float = 0.99, device=None, **kwargs) -> SACAgent:
    """State-based SAC with the reference defaults; weights drawn from a
    CPU generator seeded with `seed`. Extra kwargs pass to create_states."""
    return SACAgent.create_states(
        torch.zeros((1, obs_dim)),
        torch.zeros((1, action_dim)),
        generator=torch.Generator().manual_seed(int(seed)),
        policy_kwargs=dict(_POLICY_KWARGS),
        critic_network_kwargs=dict(_NET_KWARGS),
        policy_network_kwargs=dict(_NET_KWARGS),
        temperature_init=1e-2,
        discount=discount,
        backup_entropy=False,
        critic_ensemble_size=10,
        critic_subsample_size=2,
        device=device,
        **kwargs,
    )


def make_state_replay_buffer(capacity: int = 200_000, obs_dim: int = STATE_OBS_DIM,
                             action_dim: int = ACTION_DIM, device=None) -> ReplayBuffer:
    example = {
        "observations": torch.zeros((obs_dim,)),
        "actions": torch.zeros((action_dim,)),
        "next_observations": torch.zeros((obs_dim,)),
        "rewards": torch.zeros(()),
        "masks": torch.zeros(()),
        "dones": torch.zeros(()),
    }
    return ReplayBuffer(example, capacity=capacity, device=device)


def make_drq_agent(seed: int, sample_obs, sample_action, image_keys=("image",),
                   encoder_type: str = "small", shared_encoder: bool = False,
                   discount: float = 0.96, device=None, **kwargs):
    """Pixel DrQ with the reference defaults; weights drawn from a CPU
    generator seeded with `seed`. Extra kwargs pass to create_drq."""
    from serl_tpu_torch.agents.drq import DrQAgent

    return DrQAgent.create_drq(
        sample_obs,
        sample_action,
        encoder_type=encoder_type,
        shared_encoder=shared_encoder,
        use_proprio=True,
        image_keys=tuple(image_keys),
        generator=torch.Generator().manual_seed(int(seed)),
        policy_kwargs=dict(_POLICY_KWARGS),
        critic_network_kwargs=dict(_NET_KWARGS),
        policy_network_kwargs=dict(_NET_KWARGS),
        temperature_init=1e-2,
        discount=discount,
        backup_entropy=False,
        critic_ensemble_size=10,
        critic_subsample_size=2,
        device=device,
        **kwargs,
    )


def make_pixel_replay_buffer(capacity: int = 200_000, image_keys=("front", "wrist"),
                             image_size: int = 128, state_dim: int = PIXEL_STATE_DIM,
                             action_dim: int = ACTION_DIM, num_stack: int = 1,
                             device=None) -> ReplayBuffer:
    """Memory-efficient pixel buffer: frames stored once, stacks and next_obs
    rebuilt at sample time."""
    example = {
        "observations": {
            "state": torch.zeros((state_dim,)),
            **{k: torch.zeros((image_size, image_size, 3), dtype=torch.uint8) for k in image_keys},
        },
        "actions": torch.zeros((action_dim,)),
        "rewards": torch.zeros(()),
        "masks": torch.zeros(()),
        "dones": torch.zeros(()),
    }
    return ReplayBuffer(example, capacity=capacity, store_next_obs=False,
                        image_keys=tuple(image_keys), num_stack=num_stack, device=device)


def make_drq_sim_experiment(seed: int = 0, encoder_type: str = "small", image_size: int = 128,
                            shared_encoder: bool = False, device=None, dp=None,
                            num_stack: int = 1, **loop_overrides):
    """The async_drq_sim-equivalent workload, pixel PandaPickCube + DrQ:
    (env, agent, rb, config, init_fn, run_chunk). The agent is built from a
    sample observation of the loop's shapes: the 7-dim state and a
    (1, num_stack, H, W, 3) uint8 stack per camera; the ring
    (`make_pixel_replay_buffer`) samples stacks of `num_stack` frames and
    the loop keeps each env's last `num_stack` frames. `dp` (a
    `distributed.sharding.DataParallel`) splits the loop over its ranks,
    on the rank's device unless `device` says otherwise."""
    from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop

    device = resolve_device(dp.device if device is None and dp is not None else device)
    env = PandaPickCubeEnv(image_obs=True, render_size=image_size, device=device)
    defaults = dict(utd_ratio=4, buffer_capacity=50_000)
    defaults.update(loop_overrides)
    config = LoopConfig(**defaults)
    config = config._replace(
        buffer_capacity=_round_up(config.buffer_capacity, config.num_envs)
    )
    rb = make_pixel_replay_buffer(capacity=config.buffer_capacity, image_size=image_size,
                                  num_stack=num_stack, device=device)
    sample = {"state": torch.zeros((1, PIXEL_STATE_DIM)),
              **{k: torch.zeros((1, num_stack, image_size, image_size, 3), dtype=torch.uint8)
                 for k in rb.image_keys}}
    agent = make_drq_agent(seed, sample, torch.zeros((1, ACTION_DIM)), image_keys=rb.image_keys,
                           encoder_type=encoder_type, shared_encoder=shared_encoder,
                           device=device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, dp=dp)
    return env, agent, rb, config, init_fn, run_chunk


def make_state_sim_experiment(seed: int = 0, device=None, dp=None, **loop_overrides):
    """Everything needed for the async_sac_state_sim-equivalent workload:
    (env, agent, rb, config, init_fn, run_chunk); `dp` as
    `make_drq_sim_experiment`'s."""
    from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop

    device = resolve_device(dp.device if device is None and dp is not None else device)
    env = PandaPickCubeEnv(device=device)
    config = LoopConfig(**loop_overrides)
    config = config._replace(
        buffer_capacity=_round_up(config.buffer_capacity, config.num_envs)
    )
    rb = make_state_replay_buffer(capacity=config.buffer_capacity, device=device)
    agent = make_sac_agent(seed, device=device)
    init_fn, run_chunk = make_fused_loop(env, rb, config, dp=dp)
    return env, agent, rb, config, init_fn, run_chunk
