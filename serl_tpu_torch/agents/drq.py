"""DrQ: SAC from pixels with random-crop augmentation of the update batches.

Port of `serl_tpu/agents/drq.py`: the encoder registry (`make_image_encoders`,
"small"), `DrQAgent.data_augmentation_fn`, `_augment_batch`,
`update_high_utd` and `create_drq`. The per-camera encoders, wrapped in an
`ObsEncoder`, live in the "critic" group (agents/sac.py).

The augmentation runs once on the whole UTD batch, before it is split into
minibatches: every image key of obs and of next_obs gets its own crops, one
window offset per (batch, stack) image, all cut by one K3 launch
(`vision/augmentations.py::crop_images`). Its offsets are part of the
update's draws, so the tests can feed the JAX package's.

The registry's "resnet" is a ResNet-10 per camera (bf16 convolutions,
trained, a learned-spatial-embedding head with dropout and a 256-wide
bottleneck); "resnet50" the same with ResNet-v1-50's bottleneck blocks
(stages 3-4-6-3, a 2048-channel map), which the JAX package's registry does
not have; "resnet-pretrained" a frozen fp32 ResNet-10 backbone per
camera (one instance per key, as the JAX package's flax tree has it) under
a trained head of the same kind, grafted from `resnet10_params.pkl` by
`create_drq` (strict: no file, no agent).

Not ported yet, and raising: `update_critics` (the fused loop does not call
it).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch

from serl_tpu_torch.agents.sac import SACAgent
from serl_tpu_torch.distributed.sharding import local, num_ranks
from serl_tpu_torch.utils.pretrained import load_resnet10_params
from serl_tpu_torch.utils.timer import span
from serl_tpu_torch.vision.augmentations import crop_images, crop_offsets
from serl_tpu_torch.vision.encoders import PreTrainedResNetEncoder, SmallEncoder, resnetv1_configs
from serl_tpu_torch.vision.encoding import ObsEncoder

CROP_PADDING = 4
# the trained ResNets of the registry: encoder type -> backbone, each under
# the learned-embedding head (8 features, dropout) and a 256-wide bottleneck
TRAINED_RESNETS = {"resnet": "resnetv1-10", "resnet50": "resnetv1-50"}


def make_image_encoders(encoder_type: str, image_keys: Iterable[str], shared: bool = False,
                        in_channels: int = 3, image_size=128,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
    """Encoder registry: image key -> encoder module (`shared=True` maps one
    module to every key; "resnet-pretrained" always builds one per key).
    `in_channels` is each camera's channels times its frame stack,
    `image_size` its (H, W) or side."""
    image_keys = tuple(image_keys)
    if encoder_type == "small":
        def small():
            return SmallEncoder(in_channels, features=(32, 64, 128, 256), kernel_sizes=(3, 3, 3, 3),
                                strides=(2, 2, 2, 2), padding="VALID", pool_method="avg",
                                bottleneck_dim=256, compute_dtype=torch.bfloat16,
                                generator=generator)

        if shared:
            enc = small()
            return {key: enc for key in image_keys}
        return {key: small() for key in image_keys}
    if encoder_type in TRAINED_RESNETS:
        def resnet():
            return resnetv1_configs[TRAINED_RESNETS[encoder_type]](
                pooling_method="spatial_learned_embeddings", num_spatial_blocks=8,
                bottleneck_dim=256, compute_dtype=torch.bfloat16, in_channels=in_channels,
                image_size=image_size, generator=generator)

        if shared:
            enc = resnet()
            return {key: enc for key in image_keys}
        return {key: resnet() for key in image_keys}
    if encoder_type == "resnet-pretrained":
        return {key: PreTrainedResNetEncoder(
            resnetv1_configs["resnetv1-10-frozen"](in_channels=in_channels,
                                                   image_size=image_size, generator=generator),
            pooling_method="spatial_learned_embeddings", num_spatial_blocks=8,
            bottleneck_dim=256, generator=generator) for key in image_keys}
    raise NotImplementedError(f"unknown encoder type {encoder_type}")


def _images(observations: Dict) -> Dict:
    return observations["images"] if "images" in observations else observations


class DrQAgent(SACAgent):
    def augment_draws(self, batch: Dict, generator: Optional[torch.Generator] = None,
                      batch_size: Optional[int] = None) -> Dict:
        """Crop offsets for `batch`, or for a batch of `batch_size` rows like
        it: {"observations" | "next_observations": {image key: (B * T, 2)
        int64}}, uniform in [0, 2 * CROP_PADDING]."""
        out = {}
        for part in ("observations", "next_observations"):
            images = _images(batch[part])
            out[part] = {}
            for k in self.config.image_keys:
                rows, stack = images[k].shape[0], math.prod(images[k].shape[1:-3])
                out[part][k] = crop_offsets((batch_size or rows) * stack, CROP_PADDING, generator,
                                            images[k].device)
        return out

    def data_augmentation_fn(self, observations: Dict, offsets: Dict) -> Dict:
        """Random-crop every image key of one observation batch, pad 4, one
        window per (batch, stack) image; `offsets`: {key: (B * T, 2)}."""
        return self._crop({"o": observations}, {"o": offsets})["o"]

    def _crop(self, parts: Dict, offsets: Dict) -> Dict:
        """Crop the image keys of several observation batches in one K3
        launch: parts {name: observations}, offsets {name: {key: offsets}}."""
        jobs = [(name, key) for name in parts for key in self.config.image_keys]
        if not jobs:
            return parts
        imgs = [_images(parts[name])[key] for name, key in jobs]
        num_batch_dims = 2 if imgs[0].dim() == 5 else 1
        cropped = crop_images(imgs, [offsets[name][key] for name, key in jobs],
                              padding=CROP_PADDING, num_batch_dims=num_batch_dims)
        out = {}
        for name, obs in parts.items():
            obs = dict(obs)
            images = dict(_images(obs))
            for (n, key), img in zip(jobs, cropped):
                if n == name:
                    images[key] = img
            if "images" in obs:
                obs["images"] = images
            else:
                obs = images
            out[name] = obs
        return out

    def _augment_batch(self, batch: Dict, offsets: Dict) -> Dict:
        if not self.config.augment:
            return batch
        parts = ("observations", "next_observations")
        with span("learner.augment"):
            cropped = self._crop({p: batch[p] for p in parts}, offsets)
        return {**batch, **cropped}

    def drq_draws(self, batch: Dict, utd_ratio: int,
                  generator: Optional[torch.Generator] = None,
                  batch_size: Optional[int] = None) -> Dict:
        """The draws of one `update_high_utd` of `batch` (or of a batch of
        `batch_size` rows like it): {"augment": crop offsets (see
        `augment_draws`), "updates": SAC's per-update draws}."""
        batch_size = batch_size or batch["rewards"].shape[0]
        return {"augment": (self.augment_draws(batch, generator, batch_size)
                            if self.config.augment else {}),
                "updates": self.high_utd_draws(batch_size, utd_ratio, generator)}

    def update_high_utd(self, batch: Dict, *, utd_ratio: int, draws: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None):
        """Augment the whole batch once, then SAC's `update_high_utd` on it
        (`utd_ratio` critic updates on contiguous minibatches, then one
        actor+temperature update); returns (self, info). `draws` as
        `drq_draws` gives them. Under data parallelism `batch` is the rank's
        block of the global batch and the draws are the global batch's: the
        rank crops its rows with their own offsets, and SAC's update hands
        the cropped rows on (`distributed/sharding.py`)."""
        with span("learner.update"):  # SAC's update_high_utd, inside it, opens none
            dp = self.state.dp
            batch_size = batch["rewards"].shape[0] * num_ranks(dp)
            if draws is None:
                with span("learner.draws"):
                    draws = self.drq_draws(batch, utd_ratio, generator, batch_size)
            offsets = {part: {k: local(v.reshape(batch_size, -1, 2), dp).reshape(-1, 2)
                              for k, v in by_key.items()}
                       for part, by_key in draws["augment"].items()}
            batch = self._augment_batch(batch, offsets)
            return SACAgent.update_high_utd(self, batch, utd_ratio=utd_ratio,
                                            draws=draws["updates"])

    def critic_draws(self, batch: Dict, generator: Optional[torch.Generator] = None) -> Dict:
        """The draws of one `update_critics` of `batch`: {"augment": crop
        offsets (see `augment_draws`), "update": SAC's critic update draws}."""
        return {"augment": self.augment_draws(batch, generator) if self.config.augment else {},
                "update": self.update_draws(batch["rewards"].shape[0], frozenset({"critic"}),
                                            generator)}

    def update_critics(self, batch: Dict, *, draws: Optional[Dict] = None,
                       generator: Optional[torch.Generator] = None):
        """A critic-only update of the augmented batch (the other groups step
        with zero gradients, as in `update`); returns (self, info) without
        the actor's and temperature's entries. `draws` as `critic_draws`."""
        if draws is None:
            draws = self.critic_draws(batch, generator)
        batch = self._augment_batch(batch, draws["augment"])
        return self._critic_update(batch, draws["update"])

    def _critic_update(self, batch: Dict, draws: Dict):
        _, info = SACAgent.update(self, batch, networks_to_update=frozenset({"critic"}),
                                  draws=draws)
        info.pop("actor", None)
        info.pop("temperature", None)
        return self, info

    @classmethod
    def create_drq(
        cls,
        observations: Dict,
        actions: torch.Tensor,
        *,
        encoder_type: str = "small",
        shared_encoder: bool = False,
        shared_batch_concat: bool = True,
        use_proprio: bool = True,
        custom_encoders: Optional[Dict[str, torch.nn.Module]] = None,
        augment: bool = True,
        image_keys: Iterable[str] = ("image",),
        generator: Optional[torch.Generator] = None,
        device=None,
        **kwargs,
    ) -> "DrQAgent":
        """A DrQ agent for the example batch `observations` ({"state": (B, S),
        "<key>": (B, T, H, W, C) uint8}); weights from `generator` on the CPU,
        then moved to `device`. `custom_encoders` (image key -> module)
        replaces the registry's. kwargs as `SACAgent.create`."""
        image_keys = tuple(image_keys)
        first = _images(observations)[image_keys[0]]
        in_channels = first.shape[-1] * (first.shape[-4] if first.dim() == 5 else 1)
        encoders = custom_encoders or make_image_encoders(
            encoder_type, image_keys, shared=shared_encoder, in_channels=in_channels,
            image_size=tuple(first.shape[-3:-1]), generator=generator)
        state = observations["state"]
        state_dim = (sum(v.shape[-1] for v in state.values()) if isinstance(state, dict)
                     else state.shape[-1])
        encoder = ObsEncoder(encoders, image_keys, state_dim, use_proprio=use_proprio,
                             enable_stacking=True, shared_batch_concat=shared_batch_concat,
                             generator=generator)
        agent = cls.create_pixels(observations, actions, encoder=encoder, image_keys=image_keys,
                                  generator=generator, device=device, **kwargs)
        agent.config = agent.config._replace(augment=bool(augment))
        if encoder_type == "resnet-pretrained":
            # pretrained weights were asked for: no file, no agent (never a
            # silently random frozen backbone)
            load_resnet10_params(agent, image_keys)
        return agent
