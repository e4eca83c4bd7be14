"""serl_tpu_torch: the PyTorch / CUDA port of serl_tpu.

The package keeps serl_tpu's module tree and names. It imports torch and
numpy, never jax or serl_tpu. Entry points run on "cuda" unless the caller
passes device="cpu"; a CUDA request on a machine without CUDA raises.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to "cuda"; raises if CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return device
