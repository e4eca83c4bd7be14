"""Binary reward classifiers.

Port of `serl_tpu/networks/classifier.py`: `BinaryClassifier` (an
observation encoder, then Dense 256 -> Dropout(0.1) -> LayerNorm -> relu ->
Dense 1 -> a logit), its optimizer state, `create_classifier`,
`classifier_train_step` (sigmoid BCE, mean, and the accuracy),
`classifier_fn`, `save_classifier` and `load_classifier_func`.

The head is plain torch: Dropout comes before its LayerNorm (flax's eps,
1e-6) and the activation is relu, so it is not K5's Dense -> LayerNorm ->
tanh; the encoder's bottleneck still goes through K5. In train mode the
head's dropout takes its keep-mask (B, 256) from the caller, as every draw
of the port does; an encoder whose pooling has dropout (the ResNet heads)
takes its masks too.

The encoder is an `ObsEncoder` without proprio over the registry's
encoders (agents/drq.py::make_image_encoders): "small" or
"resnet-pretrained", whose frozen ResNet-10 is grafted from
`resnet10_params.pkl` strictly (no file, no classifier). The JAX package's
`_graft_pretrained` keeps a random backbone when the file is missing and,
when it is found, looks the camera up as `encoder_<key>` where flax names it
`encoders_<key>` (a KeyError); the port grafts under flax's name.

A saved classifier is the JAX package's file: a pickle of the flax-shaped
numpy param tree {"encoder_def": {"encoders_<key>": ...}, "Dense_0",
"LayerNorm_0", "Dense_1"}, so either package loads the other's.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from serl_tpu_torch import resolve_device
from serl_tpu_torch.common.optimizers import make_optimizer
from serl_tpu_torch.networks.dense_layer_norm_tanh import LAYER_NORM_EPS
from serl_tpu_torch.vision.encoders import DROPOUT_RATE, dropout, lecun_dense
from serl_tpu_torch.vision.encoding import ObsEncoder


class ClassifierHead(nn.Module):
    """features -> Dense(hidden) -> Dropout(0.1) -> LayerNorm(1e-6) -> relu ->
    Dense(1) -> logits (..., ); both Dense layers initialised like flax's
    default (lecun_normal, zero bias)."""

    def __init__(self, in_features: int, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = lecun_dense(in_features, hidden_dim, generator)
        self.norm = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.out = lecun_dense(hidden_dim, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = dropout(self.dense(x), train, mask)
        x = F.relu(self.norm(x))
        return self.out(x).squeeze(-1)


def dropout_mask(rows: int, features: int = 256, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """A (rows, features) keep-mask of flax's Dropout(0.1)."""
    return torch.rand((rows, features), generator=generator, device=device) < 1.0 - DROPOUT_RATE


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's elementwise sigmoid BCE: -y log s(x) - (1 - y) log s(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class BinaryClassifier(nn.Module):
    """Encoder + head -> logit. `return_encoded` stops after the encoder;
    `classify_encoded` runs the head on given features."""

    def __init__(self, encoder_def: ObsEncoder, hidden_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder_def = encoder_def
        self.head = ClassifierHead(encoder_def.out_features, hidden_dim, generator)

    def forward(self, x, train: bool = False, return_encoded: bool = False,
                classify_encoded: bool = False, dropout: Optional[torch.Tensor] = None,
                encoder_dropout: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        if not classify_encoded:
            x = self.encoder_def(x, train=train, dropout=encoder_dropout)
            if return_encoded:
                return x
        return self.head(x, train, dropout)


class ClassifierState:
    """The classifier, its optimizer (plain Adam, optax.adam's constants) and
    optimizer state, and the count of steps taken."""

    def __init__(self, classifier: BinaryClassifier, learning_rate: float = 1e-4):
        self.classifier = classifier
        self.params = list(classifier.parameters())
        self.tx = make_optimizer(learning_rate=learning_rate)
        self.opt_state = self.tx.init(self.params)
        self.step = 0

    def apply_gradients(self, grads) -> "ClassifierState":
        self.opt_state = self.tx.step(self.params, grads, self.opt_state)
        self.step += 1
        return self


def _in_shape(sample: Dict, key: str) -> Tuple[int, tuple]:
    """(channels times frame stack, (H, W)) of the sample's camera `key`."""
    img = sample.get("images", sample)[key]
    stack = img.shape[-4] if img.dim() == 5 else 1
    return img.shape[-1] * stack, tuple(img.shape[-3:-1])


def create_classifier(sample: Dict, image_keys: Sequence[str],
                      encoder_type: str = "resnet-pretrained", learning_rate: float = 1e-4,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> ClassifierState:
    """A classifier over the cameras `image_keys` of observations shaped as
    `sample` ({key: (B, T, H, W, C) uint8}); weights from `generator` on the
    CPU, then moved to `device` ("cuda" unless given). "resnet-pretrained"
    grafts the frozen backbone from resnet10_params.pkl (raises without it)."""
    from serl_tpu_torch.agents.drq import make_image_encoders
    from serl_tpu_torch.utils.pretrained import graft_resnet10

    image_keys = tuple(image_keys)
    in_channels, size = _in_shape(sample, image_keys[0])
    encoders = make_image_encoders(encoder_type, image_keys, in_channels=in_channels,
                                   image_size=size, generator=generator)
    encoder = ObsEncoder(encoders, image_keys, state_dim=0, use_proprio=False,
                         enable_stacking=True)
    classifier = BinaryClassifier(encoder, generator=generator)
    if encoder_type == "resnet-pretrained":
        graft_resnet10(encoder, image_keys)
    classifier = classifier.to(resolve_device(device))
    return ClassifierState(classifier, learning_rate)


def classifier_draws(state: ClassifierState, batch_size: int,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """The dropout keep-masks of one train step: {"head": (B, 256),
    "encoder": {key: mask} for encoders whose pooling has dropout}."""
    device = state.params[0].device
    head = state.classifier.head.dense.out_features
    shapes = state.classifier.encoder_def.dropout_shapes(batch_size)
    return {"head": dropout_mask(batch_size, head, generator, device),
            "encoder": {k: dropout_mask(*s, generator, device) for k, s in shapes.items()}}


def classifier_train_step(state: ClassifierState, batch: Dict, draws: Optional[Dict] = None,
                          generator: Optional[torch.Generator] = None):
    """One BCE step on {"observations": obs dict, "labels": (B,)}, in place;
    returns (state, {"loss", "accuracy"}). `draws` as `classifier_draws`."""
    labels = batch["labels"]
    if draws is None:
        draws = classifier_draws(state, labels.shape[0], generator)
    logits = state.classifier(batch["observations"], train=True, dropout=draws["head"],
                              encoder_dropout=draws.get("encoder"))
    loss = sigmoid_binary_cross_entropy(logits, labels).mean()
    grads = torch.autograd.grad(loss, state.params, allow_unused=True, materialize_grads=True)
    acc = ((logits.detach() > 0) == (labels > 0.5)).to(torch.float32).mean()
    state.apply_gradients(list(grads))
    return state, {"loss": loss.detach(), "accuracy": acc}


def classifier_fn(state: ClassifierState) -> Callable:
    """obs -> logits in eval mode (no dropout), without gradients."""
    classifier = state.classifier

    @torch.no_grad()
    def fn(obs):
        return classifier(obs, train=False)

    return fn


def classifier_tree(state: ClassifierState) -> Dict:
    """The classifier's params as the JAX package's flax tree of numpy arrays."""
    from serl_tpu_torch.utils.jax_params import classifier_pairs, pairs_to_tree

    return pairs_to_tree(classifier_pairs(state.classifier))


def save_classifier(state: ClassifierState, path: str, step: Optional[int] = None) -> None:
    """Pickle the params as the JAX package's numpy tree (`step` unused, as there)."""
    with open(path, "wb") as f:
        pickle.dump(classifier_tree(state), f)


def load_classifier_params(state: ClassifierState, tree: Dict) -> ClassifierState:
    """Copy a flax-layout classifier tree (numpy leaves) into `state`, every
    leaf (strict: a missing leaf or another shape raises)."""
    from serl_tpu_torch.utils.jax_params import classifier_pairs, load_pairs

    load_pairs(classifier_pairs(state.classifier), tree)
    return state


def load_classifier_func(sample: Dict, image_keys: Sequence[str], checkpoint_path: str,
                         encoder_type: str = "resnet-pretrained", device=None) -> Callable:
    """Rebuild the classifier (the JAX package's default encoder unless
    `encoder_type` names another), load the saved params, and return its
    obs -> logit function. Unpickling runs code: load only files this
    project wrote."""
    state = create_classifier(sample, image_keys, encoder_type=encoder_type,
                              generator=torch.Generator().manual_seed(0), device=device)
    with open(checkpoint_path, "rb") as f:
        tree = pickle.load(f)
    return classifier_fn(load_classifier_params(state, tree))
