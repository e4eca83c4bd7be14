"""A configuration is added with files and entries alone: a test-only third
one (`newconfig/`: a ResNet-10 trained end to end, the program's
encoder_type "resnet", under the learned-embedding head) is copied beside
the harness into a fresh tree, with its entries added to that tree's
BENCHMARK.json, and checked end to end there on the CPU. No module of the
harness is edited; each new file is one that the harness finds by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest

FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "newconfig")
KINDS = ("configs", "flops", "reference", "limits")
CELL = "toy_trained.learn"

RUN = """
import json
from _pytest.monkeypatch import MonkeyPatch
from benchmark import manifest
from benchmark.tests.helpers import run_tiny
from benchmark.tests.test_bench_faults import FAULTS

assert manifest.HERE.startswith({root!r}), manifest.HERE
out = {{"sound": run_tiny({cell!r}), "control": run_tiny({cell!r}, mode="control")}}
for fault in ("unchanged_state", "half_batch"):
    patch = MonkeyPatch()
    FAULTS[fault](patch)
    out[fault] = run_tiny({cell!r})
    patch.undo()
print(json.dumps({{k: {{"correct": r["correct"], "checks": r["checks"]}} for k, r in out.items()}}))
"""


def _tree(root: str) -> None:
    """The harness as committed, plus the new configuration's files and entries."""
    shutil.copytree(manifest.HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind in KINDS:
        for name in os.listdir(os.path.join(FILES, kind)):
            target = os.path.join(root, "benchmark", kind, name)
            assert not os.path.exists(target), target  # added, never edited
            shutil.copy(os.path.join(FILES, kind, name), target)
    bench = manifest.benchmark()
    for key, entries in manifest.load_json(os.path.join(FILES, "entries.json")).items():
        bench[key] += entries
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def _python(root: str, *args, timeout=900):
    env = {**os.environ, "PYTHONPATH": manifest.ROOT}  # the program; the harness is the tree's
    out = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                         timeout=timeout, env=env)
    assert out.returncode == 0, out.stderr[-3000:] + out.stdout[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("newconfig"))
    _tree(root)
    return root


def test_a_new_configuration_is_checked_end_to_end(tree):
    runs = json.loads(_python(tree, "-c", RUN.format(root=tree, cell=CELL)).splitlines()[-1])
    sound = runs.pop("sound")
    assert sound["correct"], sound["checks"]
    for name, run in runs.items():  # the control and the planted faults
        assert not run["correct"], (name, run["checks"])


def test_the_new_tree_keeps_the_manifests_rules(tree):
    _python(tree, "-m", "pytest", "-q", "-p", "no:cacheprovider", "benchmark/tests/test_bench_manifest.py")
