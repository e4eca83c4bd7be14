"""Small sizes at which a test drives a whole cell on the CPU."""

import torch

from benchmark.reference.drq import DROPOUT_KEEP

TINY_TRAFFIC = {"learn": dict(num_envs=4, batch_size=8, utd_ratio=2, training_starts=16,
                              random_steps=16, buffer_capacity=400, warmup_iters=1),
                "collect": dict(num_envs=4, random_steps=4, buffer_capacity=32, warmup_iters=1)}
TINY_CONFIG = {"image_size": 32}
LEARN_CELLS = ("resnet10.learn", "small.learn")
COLLECT_CELLS = ("small.collect",)
CELLS = LEARN_CELLS + COLLECT_CELLS


def run_tiny(workload, mode="program", traced=False, seed=20260418, seconds=0.5):
    from benchmark import manifest, run

    torch.manual_seed(0)
    torch.set_num_threads(2)
    tiny = TINY_TRAFFIC[manifest.cell(workload)["traffic"]]
    return run.run_cell(workload, seed, seconds, traced, torch.device("cpu"), mode,
                        tiny, TINY_CONFIG, log=lambda msg: None)


def reference_params(config, g):
    """Random weights under the port's parameter names, for the reference alone."""
    e, a, h = config["critic_ensemble_size"], config["action_dim"], config["hidden_dims"]
    enc = config["encoder"]
    shapes = {"temperature_raw": ()}
    feat = len(config["image_keys"]) * enc["bottleneck_dim"] + config["proprio_latent_dim"]
    for i, (k, d) in enumerate(zip([feat] + h[:-1], h)):
        shapes.update({f"actor.trunk.dense.{i}.weight": (d, k), f"actor.trunk.dense.{i}.bias": (d,),
                       f"actor.trunk.norms.{i}.weight": (d,), f"actor.trunk.norms.{i}.bias": (d,),
                       f"critic.trunk.norms.{i}.weight": (d,), f"critic.trunk.norms.{i}.bias": (d,),
                       f"critic.trunk.dense.{i}.kernel": (e, k + (a if i == 0 else 0), d),
                       f"critic.trunk.dense.{i}.bias": (e, d)})
    for head in ("mean", "std_head"):
        shapes.update({f"actor.{head}.weight": (a, h[-1]), f"actor.{head}.bias": (a,)})
    shapes.update({"critic.head.kernel": (e, h[-1], 1), "critic.head.bias": (e, 1),
                   "encoder.proprio.weight": (config["proprio_latent_dim"], config["proprio_dim"]),
                   "encoder.proprio.bias": (config["proprio_latent_dim"],),
                   "encoder.proprio_norm.weight": (config["proprio_latent_dim"],),
                   "encoder.proprio_norm.bias": (config["proprio_latent_dim"],)})
    for key in config["image_keys"]:
        p = f"encoder.encoders.{key}"
        if config["encoder_type"] == "small":
            cin, size = 3, config["image_size"]
            for i, cout in enumerate(enc["features"]):
                shapes.update({f"{p}.convs.{i}.weight": (cout, cin, 3, 3), f"{p}.convs.{i}.bias": (cout,)})
                cin, size = cout, (size - 3) // 2 + 1
            k = cin
        else:
            side = config["image_size"]
            for _ in range(5):
                side = -(-side // 2)
            c, f = enc["widths"][-1], enc["num_spatial_blocks"]
            shapes[f"{p}.pool.embeddings.kernel"] = (side, side, c, f)
            k = c * f
        shapes.update({f"{p}.bottleneck.dense.weight": (enc["bottleneck_dim"], k),
                       f"{p}.bottleneck.dense.bias": (enc["bottleneck_dim"],),
                       f"{p}.bottleneck.norm.weight": (enc["bottleneck_dim"],),
                       f"{p}.bottleneck.norm.bias": (enc["bottleneck_dim"],)})
    return {n: torch.randn(s, generator=g) * 0.1 for n, s in shapes.items()}


def update_draws(config, traffic, g, device):
    """The draws of one `update_high_utd` in the port's `drq_draws` layout,
    for driving the reference alone."""
    b, utd = traffic["batch_size"], traffic["utd_ratio"]
    rows, act = b * utd, config["action_dim"]
    keys = config["image_keys"]
    pad = config["crop_padding"]
    enc = config["encoder"]
    drop = enc.get("dropout_rate") and enc["widths"][-1] * enc["num_spatial_blocks"]

    def masks(n):
        return {k: torch.rand((n, drop), generator=g, device=device) < DROPOUT_KEEP for k in keys}

    augment = {part: {k: torch.randint(0, 2 * pad + 1, (rows, 2), generator=g, device=device)
                      for k in keys} for part in ("observations", "next_observations")}
    updates = []
    for _ in range(utd):
        d = {"critic_next_eps": torch.randn((b, act), generator=g, device=device),
             "subsample_idx": torch.randint(0, config["critic_ensemble_size"],
                                            (config["critic_subsample_size"],),
                                            generator=g, device=device)}
        if drop:
            d.update({f"{p}_dropout": masks(b) for p in ("critic_next", "target", "critic")})
        updates.append(d)
    d = {"actor_eps": torch.randn((rows, act), generator=g, device=device),
         "temperature_next_eps": torch.randn((rows, act), generator=g, device=device)}
    if drop:
        d.update({f"{p}_dropout": masks(rows) for p in ("actor", "actor_critic", "temperature_next")})
    updates.append(d)
    return {"augment": augment, "updates": updates}
