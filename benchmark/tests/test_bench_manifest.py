"""The manifest finds every piece of a cell by the names in BENCHMARK.json,
and BENCHMARK.json keeps to the shape that the harness reads."""

import os
import re

import pytest

from benchmark import manifest
from benchmark.counting import Call

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_finds_its_config_traffic_flops_and_metrics():
    bench = manifest.benchmark()
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        config = manifest.load_json(os.path.join(manifest.ROOT, cell["config_entry"]["file"]))
        traffic = manifest.traffic(w["traffic"])
        calls = manifest.flops(w["config"]).calls(config, traffic)
        assert set(calls) == {"policy", "update", "iteration"}
        assert all(isinstance(c, Call) for c in calls["iteration"])
        for m in cell["per_layer"]:
            assert callable(manifest.metric(m["name"]).read)
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "env_steps_per_s"}
        assert os.path.isfile(os.path.join(manifest.HERE, "limits", f"{w['name']}.json"))


def test_a_missing_piece_is_named():
    with pytest.raises(KeyError):
        manifest.cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        manifest.metric("no_such_metric")


def test_benchmark_json_keeps_its_shape():
    bench = manifest.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(manifest.ROOT, c["file"]))
        config = manifest.load_json(os.path.join(manifest.ROOT, c["file"]))
        assert config["reduced"] == c["reduced"] and config["name"] == c["name"]
        assert callable(manifest.reference(c["name"]).Encoder)
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", cells)) <= cells
