"""Type aliases shared across serl_tpu_torch (the port of
`serl_tpu/common/typing.py`; a random key becomes a torch.Generator)."""

from typing import Any, Dict, Mapping, Union

import torch

PRNGKey = torch.Generator
Params = Any  # nested dict of tensors
Data = Union[torch.Tensor, Mapping[str, "Data"]]
Batch = Dict[str, Data]
Info = Dict[str, Any]
