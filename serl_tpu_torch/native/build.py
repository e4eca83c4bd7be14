"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel library is one `csrc/<name>.cu` (plus the `csrc/*.cuh` headers)
with a plain C interface. It is compiled at first use into
`serl_tpu_torch/_build/` (listed in .gitignore), under a file name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Every csrc/<name>.cu, in the order of the kernels K1 to K5
KERNEL_SOURCES = ("control_step", "render", "random_crop", "replay_gather",
                  "dense_layer_norm_tanh")


def find_nvcc() -> str:
    for path in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(extra=None):
    """nvcc's flags, with `extra` after them for a variant (chip_smoke.py's
    -fmad=false build of render.cu). Every kernel takes nvcc's default
    -fmad=true: a fused multiply-add rounds once where the plain versions
    round twice, which their tolerances (K5) and the pixel rule (K2) hold."""
    return NVCC_FLAGS + tuple(extra or ())


def _source_hash(source: str, extra=None) -> str:
    h = hashlib.sha256(" ".join(_flags(extra)).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _output(name: str, extra=None):
    source = os.path.join(CSRC, f"{name}.cu")
    return source, os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(source, extra)}.so")


def ptxas_path(name: str, extra=None) -> str:
    """What `-Xptxas -v` said (registers, spills per kernel) for a build."""
    return _output(name, extra)[1][: -len(".so")] + ".ptxas.txt"


def build_all(names, variants=()) -> dict:
    """Compile every csrc/<name>.cu, and every (name, extra flags) of
    `variants`, that has no build of the same sources and flags yet, one
    nvcc per build, all started together; returns {name or (name, extra):
    shared library path}. Waits for every nvcc before it raises for any."""
    targets = [(name, None) for name in names] + [(name, tuple(extra)) for name, extra in variants]
    started = {}
    for name, extra in targets:
        source, out = _output(name, extra)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        started[(name, extra)] = (
            subprocess.Popen([find_nvcc(), *_flags(extra), "-o", tmp, source],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            source, tmp, out)
    failed = []
    for (name, extra), (proc, source, tmp, out) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{stdout}\n{stderr}")
            continue
        with open(ptxas_path(name, extra), "w") as f:
            f.write(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {(name if extra is None else (name, extra)): _output(name, extra)[1]
            for name, extra in targets}


def build(name: str, extra=None) -> str:
    """Compile csrc/<name>.cu (with the `extra` flags, if given) unless a
    build of the same sources and flags exists; returns the shared
    library's path."""
    if extra is None:
        return build_all([name])[name]
    return build_all([], [(name, extra)])[(name, tuple(extra))]


def load_library(name: str, extra=None) -> ctypes.CDLL:
    return ctypes.CDLL(build(name, extra))
