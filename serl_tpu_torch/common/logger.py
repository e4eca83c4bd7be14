"""Metrics logging.

The port's own copy of `serl_tpu/common/logger.py`, cut to its JSONL
backend: nested dicts flatten to "a/b" keys, tensors and arrays become
scalars (or short lists), and each `log` call appends one JSON line to
`<output_dir>/<description>_<stamp>.jsonl`. `debug=True` writes nothing.
"""

import datetime
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch


def _flatten(d, parent="", sep="/"):
    out = {}
    for k, v in d.items():
        key = parent + sep + k if parent else k
        if isinstance(v, dict):
            out.update(_flatten(v, key, sep))
        else:
            out[key] = v
    return out


def _to_scalar(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist() if arr.size <= 16 else float(arr.mean())


class Logger:
    """A JSONL metrics log with the JAX package's Logger surface."""

    def __init__(self, description: str = "run", output_dir: Optional[str] = None,
                 variant: Optional[dict] = None, debug: bool = False):
        self.debug = debug
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.run_name = f"{description}_{stamp}"
        self.output_dir = output_dir or os.path.join(tempfile.gettempdir(), "serl_tpu_logs")
        self.path = os.path.join(self.output_dir, self.run_name + ".jsonl")
        self._fh = None
        if not debug:
            os.makedirs(self.output_dir, exist_ok=True)
            self._fh = open(self.path, "a")
        if variant and self._fh:
            self._fh.write(json.dumps({"_config": _flatten(variant)}) + "\n")

    def log(self, data: dict, step: Optional[int] = None):
        flat = {k: _to_scalar(v) for k, v in _flatten(data).items()}
        if step is not None:
            flat["_step"] = int(step)
        if self._fh:
            self._fh.write(json.dumps(flat) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


WandBLogger = Logger  # the reference's name (wandb itself is not used)
