"""Observation -> flat-feature encoders: dict observations, and (obs, goal) pairs.

Port of `serl_tpu/vision/encoding.py`. `ObsEncoder`: per-camera
encoders, each camera's frame stack folded into channels
((B, T, H, W, C) -> (B, H, W, T * C)), the proprio state through Dense(64)
(xavier_uniform) -> LayerNorm -> tanh (K5, one fused op), and the
concatenation camera features in `image_keys` order, then proprio.

`shared_batch_concat` is ported as it is: it takes effect only when one
encoder module serves every camera (the images are then stacked on the
batch axis and run through it once). The DrQ factory defaults it to True,
which with separate per-camera encoders changes nothing (an inherited
quirk).

`train` and the dropout keep-masks ({image key: (B, F) bool}, for the keys
whose encoder pools with learned spatial embeddings; `dropout_shapes` gives
their shapes) go to each camera's encoder; with one encoder shared and the cameras
stacked, it takes the first key's mask for the stacked batch, as flax's one
call draws one. With `is_encoded=True` the images are already each
camera's pre-pooling map: no frame-stack fold, no camera stacking, and each
encoder runs its head alone (`encode=False`).

`GCObsEncoder` takes an (observations, goals) pair of dicts: the
observation's and the goal's "image" concatenated on channels through one
encoder (early fusion: a 6-channel input for RGB), or each through its own
tower, `encoder` then `goal_encoder` (late fusion), then optionally the raw
`observations["proprio"]`. `LCObsEncoder` runs its encoder on the
observation's "image" conditioned on `goals["language"]` (`cond_var`: FiLM
in the ResNet), then optionally the raw proprio. Their dropout keep-masks
are keyed by tower, "encoder" and "goal_encoder".
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS, dense_layer_norm_tanh
from serl_tpu_torch.networks.mlp import dense


def fold_stack(x: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., H, W, T * C); unstacked images pass."""
    if x.dim() == 4:  # T H W C
        t, h, w, c = x.shape
        return x.permute(1, 2, 0, 3).reshape(h, w, t * c)
    if x.dim() == 5:  # B T H W C
        b, t, h, w, c = x.shape
        return x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
    return x


class ObsEncoder(nn.Module):
    """Dict obs {"state": proprio, "<image_key>": images} (or with the images
    under "images") -> flat features. `encoders` maps each image key to its
    encoder module (one module may serve several keys)."""

    def __init__(
        self,
        encoders: Dict[str, nn.Module],
        image_keys: Sequence[str],
        state_dim: int,
        use_proprio: bool = True,
        proprio_latent_dim: int = 64,
        enable_stacking: bool = True,
        shared_batch_concat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.image_keys = tuple(image_keys)
        self.encoders = nn.ModuleDict({k: encoders[k] for k in self.image_keys})
        self.use_proprio = use_proprio
        self.enable_stacking = enable_stacking
        self.shared_batch_concat = shared_batch_concat
        self.out_features = sum(encoders[k].out_features for k in self.image_keys)
        self.proprio = self.proprio_norm = None
        if use_proprio:
            self.proprio = dense(state_dim, proprio_latent_dim, generator)
            self.proprio_norm = nn.LayerNorm(proprio_latent_dim, eps=LAYER_NORM_EPS)
            self.out_features += proprio_latent_dim

    def dropout_shapes(self, rows: int) -> Dict[str, tuple]:
        """{image key: shape of the dropout mask its encoder draws in train
        mode for a batch of `rows`}; empty when no encoder has dropout (the
        SmallEncoder's "avg" pooling)."""
        widths = {k: self.encoders[k].dropout_features for k in self.image_keys
                  if getattr(self.encoders[k], "dropout_features", 0)}
        if widths and self._stacks_cameras():
            key = self.image_keys[0]
            return {key: (rows * len(self.image_keys), widths[key])}
        return {k: (rows, f) for k, f in widths.items()}

    def _stacks_cameras(self) -> bool:
        return (self.shared_batch_concat and len(self.image_keys) > 1
                and len({id(self.encoders[k]) for k in self.image_keys}) == 1)

    def forward(self, observations: Dict, train: bool = False,
                dropout: Optional[Dict[str, torch.Tensor]] = None,
                is_encoded: bool = False) -> torch.Tensor:
        images = observations.get("images", observations)
        dropout = dropout or {}
        if is_encoded:  # each camera's pre-pooling map: its head only
            encoded = torch.cat([self.encoders[k](images[k], train=train, dropout=dropout.get(k),
                                                  encode=False) for k in self.image_keys], -1)
            return self._with_proprio(observations, encoded)
        imgs = [fold_stack(images[k]) if self.enable_stacking else images[k]
                for k in self.image_keys]
        if self._stacks_cameras() and imgs[0].dim() == 4:
            key = self.image_keys[0]
            feats = self.encoders[key](torch.cat(imgs, 0), train=train, dropout=dropout.get(key))
            encoded = torch.cat(torch.chunk(feats, len(self.image_keys), 0), -1)
        else:
            encoded = torch.cat([self.encoders[k](img, train=train, dropout=dropout.get(k))
                                 for k, img in zip(self.image_keys, imgs)], -1)
        return self._with_proprio(observations, encoded)

    def _with_proprio(self, observations: Dict, encoded: torch.Tensor) -> torch.Tensor:
        if self.use_proprio:
            state = observations["state"]
            if isinstance(state, dict):
                state = torch.cat([state[k] for k in sorted(state)], -1)
            if self.enable_stacking and state.dim() == encoded.dim() + 1:
                state = state.reshape(state.shape[:-2] + (-1,))
            state = dense_layer_norm_tanh(state, self.proprio.weight, self.proprio.bias,
                                          self.proprio_norm.weight, self.proprio_norm.bias)
            encoded = torch.cat([encoded, state], -1)
        return encoded


def _tower_dropout_shapes(towers: Dict[str, nn.Module], rows: int) -> Dict[str, tuple]:
    return {name: (rows, enc.dropout_features) for name, enc in towers.items()
            if enc is not None and getattr(enc, "dropout_features", 0)}


class GCObsEncoder(nn.Module):
    """Goal-conditioned encoder over (observations, goals) dicts: early fusion
    (the two "image"s concatenated on channels, one `encoder`) or late
    fusion (`encoder` on the observation's, `goal_encoder` on the goal's),
    then the raw `observations["proprio"]` of width `proprio_dim` with
    `use_proprio`."""

    def __init__(self, encoder: nn.Module, goal_encoder: Optional[nn.Module] = None,
                 use_proprio: bool = False, proprio_dim: int = 0):
        super().__init__()
        self.encoder = encoder
        self.goal_encoder = goal_encoder
        self.use_proprio = use_proprio
        self.out_features = (encoder.out_features
                             + (0 if goal_encoder is None else goal_encoder.out_features)
                             + (proprio_dim if use_proprio else 0))

    def dropout_shapes(self, rows: int) -> Dict[str, tuple]:
        """{tower: its dropout mask's shape in train mode for `rows` pairs}."""
        return _tower_dropout_shapes({"encoder": self.encoder,
                                      "goal_encoder": self.goal_encoder}, rows)

    def forward(self, observations_and_goals, train: bool = False,
                dropout: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        observations, goals = observations_and_goals
        dropout = dropout or {}
        obs_img, goal_img = observations["image"], goals["image"]
        if self.goal_encoder is None:
            enc = self.encoder(torch.cat([obs_img, goal_img], -1), train=train,
                               dropout=dropout.get("encoder"))
        else:
            enc = torch.cat([self.encoder(obs_img, train=train, dropout=dropout.get("encoder")),
                             self.goal_encoder(goal_img, train=train,
                                               dropout=dropout.get("goal_encoder"))], -1)
        if self.use_proprio:
            enc = torch.cat([enc, observations["proprio"]], -1)
        return enc


class LCObsEncoder(nn.Module):
    """Language-conditioned encoder over (observations, goals) dicts: the
    `encoder` (a conditioned ResNet) on the observation's "image" with
    `cond_var=goals["language"]`, then the raw proprio with `use_proprio`."""

    def __init__(self, encoder: nn.Module, use_proprio: bool = False, proprio_dim: int = 0):
        super().__init__()
        self.encoder = encoder
        self.use_proprio = use_proprio
        self.out_features = encoder.out_features + (proprio_dim if use_proprio else 0)

    def dropout_shapes(self, rows: int) -> Dict[str, tuple]:
        return _tower_dropout_shapes({"encoder": self.encoder}, rows)

    def forward(self, observations_and_goals, train: bool = False,
                dropout: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        observations, goals = observations_and_goals
        enc = self.encoder(observations["image"], train=train,
                           dropout=(dropout or {}).get("encoder"), cond_var=goals["language"])
        if self.use_proprio:
            enc = torch.cat([enc, observations["proprio"]], -1)
        return enc
