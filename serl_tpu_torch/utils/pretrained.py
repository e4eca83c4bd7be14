"""Graft the pretrained ResNet-10 into a DrQ agent's frozen backbones.

Port of `serl_tpu/utils/pretrained.py`. The pickle is looked up where the
JAX package looks (`SERL_RESNET10_PARAMS`, then ./resnet10_params.pkl, then
~/.serl/resnet10_params.pkl) and holds flax's pre-pooling ResNet-10 tree:
{"conv_init": {"kernel": (7, 7, 3, 64)}, "norm_init": {"scale", "bias"},
"ResNetBlock_0".."ResNetBlock_3": {...}}, float16 numpy arrays. Each module
of every camera's `pretrained_encoder` is copied from it, cast to the
agent's dtype (fp32) and turned from flax's HWIO kernels to OIHW, and the
target critic's copy takes the same values.

Loading is strict, as `encoder_type="resnet-pretrained"` asks of the JAX
package's loader: a missing file, a module of the agent that the pickle
lacks, a module whose tree differs, a shape that differs, or no module
grafted at all raises; it never falls back to the random initialisation.

The pickle names numpy's array classes under `numpy._core` (numpy 2).
`_NumpyUnpickler` loads it under numpy 1.x as well, by reading
`numpy._core` as `numpy.core`, and refuses any class other than numpy's
array, dtype and scalar reconstructors, so loading it runs no other code.
"""

import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from serl_tpu_torch.utils.jax_params import resnet_pairs
from serl_tpu_torch.vision.encoders import PreTrainedResNetEncoder

_ALLOWED = {("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
            ("numpy", "ndarray"), ("numpy", "dtype"), ("collections", "OrderedDict")}


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]  # numpy 1.x
        if (module.replace("numpy._core", "numpy.core"), name) not in _ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not a numpy array class")
        return super().find_class(module, name)


def find_params_file():
    for cand in (os.environ.get("SERL_RESNET10_PARAMS"), "resnet10_params.pkl",
                 os.path.expanduser("~/.serl/resnet10_params.pkl")):
        if cand and os.path.exists(cand):
            return cand
    return None


def read_params(path: str) -> Dict:
    """The pickle's tree of numpy arrays."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _leaves(sub, prefix + (k,)).items()}
    return {prefix: tree}


def graft_resnet10(encoder, image_keys: Tuple[str, ...] = ("image",)):
    """Copy the pickle's ResNet-10 into the `pretrained_encoder` of each
    camera of the ObsEncoder `encoder`, in place; returns the tensors that
    took the pickle's values."""
    path = find_params_file()
    if path is None:
        raise FileNotFoundError("resnet10_params.pkl not found (set SERL_RESNET10_PARAMS or "
                                "place it in the working directory): encoder_type="
                                "resnet-pretrained asks for it, and there is no random-init "
                                "fallback")
    encoder_params = read_params(path)
    grafted = []  # the backbone tensors that took the pickle's values
    count = 0
    for key in image_keys:
        enc = encoder.encoders[key]
        if not isinstance(enc, PreTrainedResNetEncoder):
            raise KeyError(f"encoder_{key} has no pretrained_encoder to graft into")
        modules: Dict[str, list] = {}
        for p, tensor, layout in resnet_pairs(enc.pretrained_encoder):
            modules.setdefault(p[0], []).append((p[1:], tensor, layout))
        for k, pairs in modules.items():
            if k not in encoder_params:
                raise KeyError(f"pretrained params at {path} missing module '{k}' "
                               f"(has: {sorted(encoder_params)[:8]}...)")
            leaves = _leaves(encoder_params[k])
            if set(leaves) != {p for p, _, _ in pairs}:
                raise ValueError(f"tree mismatch grafting module '{k}' into encoder_{key}: agent "
                                 f"{sorted(p for p, _, _ in pairs)} vs pickle {sorted(leaves)}")
            for p, tensor, layout in pairs:
                want = tuple(tensor.permute(2, 3, 1, 0).shape if layout == "HWIO"
                             else tensor.shape)
                if tuple(np.shape(leaves[p])) != want:
                    raise ValueError(f"shape mismatch grafting module '{k}' into encoder_{key}: "
                                     f"{'/'.join(p)} agent {want} vs pickle "
                                     f"{tuple(np.shape(leaves[p]))}")
            with torch.no_grad():
                for p, tensor, layout in pairs:
                    value = torch.from_numpy(np.asarray(leaves[p]).astype(np.float32))
                    tensor.copy_(value.permute(3, 2, 0, 1) if layout == "HWIO" else value)
                    grafted.append(tensor)
            count += 1
    if count == 0:
        raise KeyError(f"no modules grafted from {path}")
    return grafted


def load_resnet10_params(agent, image_keys: Tuple[str, ...] = ("image",)):
    """Copy the pickle's ResNet-10 into each camera's `pretrained_encoder`
    (and into the target critic), in place; returns the agent."""
    grafted = graft_resnet10(agent.encoder, image_keys)
    # the target critic starts from the same backbone
    group, targets = agent.state.params["critic"], agent.state.target_params["critic"]
    with torch.no_grad():
        for tensor in grafted:
            i = next(i for i, p in enumerate(group) if p is tensor)
            targets[i].copy_(tensor)
    return agent
