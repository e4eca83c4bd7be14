"""The frozen ResNet-10's weights, read by the reference itself from the committed pickle.

`resnet10_params.pkl` (repo root) holds flax's pre-pooling ResNet-10 tree of
float16 numpy arrays: `conv_init`, `norm_init` and `ResNetBlock_0..3`, each
block with `Conv_0`, `Conv_1`, `GroupNorm_0`, `GroupNorm_1` and, where it
strides, `conv_proj` and `norm_proj`. The unpickler accepts numpy's array
classes only, so reading the file runs no other code.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

PICKLE = "resnet10_params.pkl"
_ALLOWED = {("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
            ("numpy", "ndarray"), ("numpy", "dtype"), ("collections", "OrderedDict")}


class _NumpyOnly(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        if (module.replace("numpy._core", "numpy.core"), name) not in _ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not a numpy array class")
        return super().find_class(module, name)


def load(path: str = PICKLE, device=None) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor}: OIHW kernels "conv_init", "block{i}.conv0",
    "block{i}.conv1", "block{i}.proj"; GroupNorm "…scale" / "…bias"."""
    with open(path, "rb") as f:
        tree = _NumpyOnly(f).load()

    def kernel(a):  # flax HWIO -> OIHW
        return torch.from_numpy(np.asarray(a, np.float32)).permute(3, 2, 0, 1).contiguous()

    def vec(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    out = {"conv_init": kernel(tree["conv_init"]["kernel"]),
           "norm_init.scale": vec(tree["norm_init"]["scale"]),
           "norm_init.bias": vec(tree["norm_init"]["bias"])}
    for i in range(4):
        blk = tree[f"ResNetBlock_{i}"]
        out[f"block{i}.conv0"] = kernel(blk["Conv_0"]["kernel"])
        out[f"block{i}.conv1"] = kernel(blk["Conv_1"]["kernel"])
        for j in range(2):
            out[f"block{i}.gn{j}.scale"] = vec(blk[f"GroupNorm_{j}"]["scale"])
            out[f"block{i}.gn{j}.bias"] = vec(blk[f"GroupNorm_{j}"]["bias"])
        if "conv_proj" in blk:
            out[f"block{i}.proj"] = kernel(blk["conv_proj"]["kernel"])
            out[f"block{i}.proj_norm.scale"] = vec(blk["norm_proj"]["scale"])
            out[f"block{i}.proj_norm.bias"] = vec(blk["norm_proj"]["bias"])
    return {k: v.to(device) for k, v in out.items()}
