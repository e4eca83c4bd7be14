"""Agent/loop factories with the reference's canonical hyperparameters.

Port of the state-path factories of `serl_tpu/training/launcher.py`:
ensemble 10 / subsample 2, temperature 1e-2, tanh activations + LayerNorm
256x256, discount 0.99, exp std in [1e-5, 5]. Everything lands on `device`,
"cuda" unless the caller passes another.
"""

import torch

from serl_tpu_torch import resolve_device
from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.data.replay_buffer import ReplayBuffer
from serl_tpu_torch.envs.panda_pick import ACTION_DIM, STATE_OBS_DIM, PandaPickCubeEnv


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
        policy_kwargs={
            "tanh_squash_distribution": True,
            "std_parameterization": "exp",
            "std_min": 1e-5,
            "std_max": 5.0,
        },
        critic_network_kwargs={
            "activations": "tanh",
            "use_layer_norm": True,
            "hidden_dims": (256, 256),
        },
        policy_network_kwargs={
            "activations": "tanh",
            "use_layer_norm": True,
            "hidden_dims": (256, 256),
        },
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


def make_state_sim_experiment(seed: int = 0, device=None, **loop_overrides):
    """Everything needed for the async_sac_state_sim-equivalent workload:
    (env, agent, rb, config, init_fn, run_chunk)."""
    from serl_tpu_torch.training.loop import LoopConfig, make_fused_loop

    device = resolve_device(device)
    env = PandaPickCubeEnv(device=device)
    config = LoopConfig(**loop_overrides)
    config = config._replace(
        buffer_capacity=_round_up(config.buffer_capacity, config.num_envs)
    )
    rb = make_state_replay_buffer(capacity=config.buffer_capacity, device=device)
    agent = make_sac_agent(seed, device=device)
    init_fn, run_chunk = make_fused_loop(env, rb, config)
    return env, agent, rb, config, init_fn, run_chunk
