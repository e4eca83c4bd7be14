"""Train a binary reward classifier from success and failure frames.

Port of `examples/train_reward_classifier.py`, with its flags and defaults:
the positives are the pick env's frames where the scripted expert (noise
0.02) has lifted the cube, the negatives a random policy's frames (8
episodes each; or the observations of the --pos / --neg demo pickles);
--num_epochs BCE steps of --batch_size frames (half positives), each batch
cropped by K3 (pad 4, one window per (batch, stack) image); the params are
saved as the JAX package's pickle (`save_classifier`), which
`load_classifier_func` of either package reads. As in the JAX example, the
random policy's (4,) action and the expert's noise are one draw a step,
shared by every env.

    python -m serl_tpu_torch.examples.train_reward_classifier --out classifier.pkl

Runs on the CUDA card unless `--device cpu`.
"""

import argparse

import torch

from serl_tpu_torch.data.demos import collect_episodes, load_demos
from serl_tpu_torch.envs.panda_pick import PandaPickCubeEnv
from serl_tpu_torch.envs.scripted_expert import expert_action
from serl_tpu_torch.networks.classifier import (
    classifier_train_step,
    create_classifier,
    save_classifier,
)
from serl_tpu_torch.vision.augmentations import crop_images, crop_offsets

EPISODES = 8


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--pos", default=None, help="pickle of positive transitions")
    p.add_argument("--neg", default=None, help="pickle of negative transitions")
    p.add_argument("--image_key", default="front")
    p.add_argument("--encoder", default="small", choices=["small", "resnet", "resnet-pretrained"])
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--out", default="classifier.pkl")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def gather_frames(args, device):
    """(positive, negative) observation dicts on `device`."""
    if args.pos and args.neg:
        to = lambda obs: {k: torch.as_tensor(v, device=device) for k, v in obs.items()}
        return to(load_demos(args.pos)["observations"]), to(load_demos(args.neg)["observations"])
    env = PandaPickCubeEnv(image_obs=True, device=device)

    def expert(states, g):
        return expert_action(states, 0.02 * torch.randn((4,), generator=g, device=env.device))

    def random_policy(states, g):
        a = torch.rand((4,), generator=g, device=env.device) * 2.0 - 1.0
        return a.expand(states.t.shape[0], 4)

    gen = lambda offset: torch.Generator(device=env.device).manual_seed(args.seed + offset)
    pos_trs = collect_episodes(env, expert, gen(0), num_episodes=EPISODES, pixel_obs=True)
    neg_trs = collect_episodes(env, random_policy, gen(1), num_episodes=EPISODES,
                               pixel_obs=True)
    keep = pos_trs["success"] > 0.5  # positives: the cube lifted
    pos_obs = {k: v[keep] for k, v in pos_trs["observations"].items()}
    return pos_obs, neg_trs["observations"]


def train(args, log=print):
    """(classifier state, last step's info)."""
    pos_obs, neg_obs = gather_frames(args, args.device)
    key = args.image_key
    pos_px = pos_obs[key][:, None]  # the stack axis
    neg_px = neg_obs[key][:, None]
    log(f"positives {pos_px.shape[0]}, negatives {neg_px.shape[0]}")
    device = pos_px.device
    state = create_classifier({key: pos_px[:1]}, (key,), encoder_type=args.encoder,
                              generator=torch.Generator().manual_seed(args.seed), device=device)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    n_half = args.batch_size // 2
    labels = torch.cat([torch.ones(n_half, device=device), torch.zeros(n_half, device=device)])
    info = {}
    for epoch in range(args.num_epochs):
        pi = torch.randint(0, pos_px.shape[0], (n_half,), generator=g, device=device)
        ni = torch.randint(0, neg_px.shape[0], (n_half,), generator=g, device=device)
        px = torch.cat([pos_px[pi], neg_px[ni]], 0)
        px = crop_images([px], [crop_offsets(2 * n_half, 4, g, device)], padding=4,
                         num_batch_dims=2)[0]
        state, info = classifier_train_step(state, {"observations": {key: px}, "labels": labels},
                                            generator=g)
        if epoch % 10 == 0:
            log(f"epoch {epoch} loss {float(info['loss']):.4f} acc {float(info['accuracy']):.3f}")
    return state, info


def main(argv=None):
    args = parser().parse_args(argv)
    state, _ = train(args)
    save_classifier(state, args.out)
    print(f"saved classifier params to {args.out}")
    return state


if __name__ == "__main__":
    main()
