"""Find a cell's pieces by the names in BENCHMARK.json.

  configs/<config>.json       the configuration as it is run
  traffic/<traffic>.json      the traffic mix's parameters
  flops/<config>.py           calls(config, traffic): the work, from shapes
  reference/<config>.py       the reference's encoder and precisions (reference/drq.py)
  metrics/<metric>.py         read(run): one per-layer metric, or None
  rooflines/<kernel>.py       a kernel's name patterns and least time
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def metric(name: str):
    return _module("metrics", name)


@functools.lru_cache(maxsize=None)
def roofline(name: str):
    return _module("rooflines", name)


@functools.lru_cache(maxsize=None)
def flops(config: str):
    return _module("flops", config)


@functools.lru_cache(maxsize=None)
def reference(config: str):
    return _module("reference", config)


def config(name: str) -> Dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic(name: str) -> Dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def cell(name: str) -> Dict:
    """The cell's entry with its config, traffic, end-to-end and per-layer
    metric entries (those that list it, or list no cells)."""
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {**w, "config_entry": next(c for c in bench["configs"] if c["name"] == w["config"]),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)],
            "run_seconds": bench["run_seconds"]}
