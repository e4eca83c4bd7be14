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
# Flags of one source only. The renderer must round where its plain version
# rounds, so no multiply-add is fused there (render.cuh says why). K5
# (dense_layer_norm_tanh) keeps the general -fmad=true: its 3xTF32 products
# already sum in another order than the plain version's fp32 matmul, which
# its tolerances state, and a fused multiply-add in its epilogue rounds once
# where the plain version rounds twice, well inside them.
EXTRA_FLAGS = {"render": ("-fmad=false",)}
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


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _source_hash(name: str, source: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _output(name: str):
    source = os.path.join(CSRC, f"{name}.cu")
    return source, os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(name, source)}.so")


def build_all(names) -> dict:
    """Compile every csrc/<name>.cu that has no build of the same sources
    yet, one nvcc per source, all started together; returns {name: shared
    library path}. Waits for every nvcc before it raises for any."""
    started = {}
    for name in names:
        source, out = _output(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        started[name] = (subprocess.Popen([find_nvcc(), *_flags(name), "-o", tmp, source],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True), source, tmp, out)
    failed = []
    for name, (proc, source, tmp, out) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{stdout}\n{stderr}")
            continue
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
            f.write(stdout + stderr)  # -Xptxas -v: registers, spills per kernel
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _output(name)[1] for name in names}


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a build of the same sources exists;
    returns the shared library's path."""
    return build_all([name])[name]


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))
