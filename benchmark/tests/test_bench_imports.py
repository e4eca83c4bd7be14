"""No JAX anywhere in a run, and nothing of the program in the reference.

The top-level names are compared whole: `serl_tpu_torch` begins with
`serl_tpu` and is the program, not the JAX package."""

import ast
import os
import subprocess
import sys

from benchmark import manifest

BANNED = {"jax", "jaxlib", "flax", "serl_tpu"}


def _imports(path, whole=False):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name if whole else a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module if whole else node.module.split(".")[0]


def _sources(folder):
    for root, _, files in os.walk(folder):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(manifest.HERE):
        assert not set(_imports(path)) & BANNED, path


REFERENCE_MAY_IMPORT = {"__future__", "contextlib", "functools", "math", "pickle", "typing", "numpy",
                        "torch"}


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(manifest.HERE, "reference")):
        for name in _imports(path, whole=True):
            assert (name.split(".")[0] in REFERENCE_MAY_IMPORT
                    or name.startswith("benchmark.reference")), (path, name)


def test_a_run_loads_no_jax_module():
    code = ("import torch, sys\n"
            "from benchmark.tests.helpers import run_tiny\n"
            "from benchmark.run import banned_modules\n"
            "r = run_tiny('small.learn', traced=True)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax','jaxlib','flax','serl_tpu'}),"
            " banned_modules(), 'serl_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] [] True"


def test_without_a_card_the_command_prints_no_result():
    if __import__("torch").cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "small.learn",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
