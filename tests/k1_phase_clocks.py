"""Where K1's time goes: clock64() cycles of each phase of a substep, on the card.

    python3 tests/k1_phase_clocks.py

It builds csrc/control_step.cu (into serl_tpu_torch/_build/) with the
header's SERL_PHASE_CLOCK hook defined so that lane 0 of env 0 writes
clock64() to device memory after every phase's sync, runs one control step
of 128 rollout envs, and prints the median over the 10 substeps of each of
the substep's 16 phases (the order of control_step.cuh::substep) and their
sum, then the card's name and power limit. The writes cost some cycles a
phase: compare phases with each other, not the sum with the kernel's time. Needs a CUDA card and nvcc.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from serl_tpu_torch.envs.physics import engine  # noqa: E402
from serl_tpu_torch.native import build  # noqa: E402

# tests/torch_k1.py by its path: a package named `tests` installed elsewhere
# must not shadow it
_spec = importlib.util.spec_from_file_location("torch_k1", os.path.join(HERE, "torch_k1.py"))
torch_k1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_k1)

N_CLOCKS = 8192
CLOCK_HOOK = """#include <cuda_runtime.h>
__device__ long long g_clock[%d];
__device__ int g_clocks;
#define SERL_PHASE_CLOCK()                                                  \\
  do {                                                                      \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && g_clocks < %d)               \\
      g_clock[g_clocks++] = clock64();                                      \\
  } while (0)
""" % (N_CLOCKS, N_CLOCKS)
READ_CLOCKS = """
extern "C" int serl_read_clocks(long long* out) {
  int n = 0, zero = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&n, g_clocks, sizeof(int));
  cudaMemcpyFromSymbol(out, g_clock, sizeof(long long) * n);
  cudaMemcpyToSymbol(g_clocks, &zero, sizeof(int));
  return n;
}
"""


def build_clocked() -> ctypes.CDLL:
    """csrc/control_step.cu built with control_step.cuh's SERL_PHASE_CLOCK
    hook defined to record clock64(), and a reader of the records."""
    out_dir = os.path.join(build.BUILD_DIR, "phase_clocks")
    os.makedirs(out_dir, exist_ok=True)
    source = os.path.join(out_dir, "control_step_clocked.cu")
    with open(source, "w") as f:
        f.write(CLOCK_HOOK + f'#include "{os.path.join(build.CSRC, "control_step.cu")}"\n'
                + READ_CLOCKS)
    lib = os.path.join(out_dir, "libcontrol_step_clocked.so")
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    cdll = ctypes.CDLL(lib)
    cdll.serl_control_step.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int, ctypes.c_int,
                                                                ctypes.c_void_p]
    cdll.serl_read_clocks.argtypes = [ctypes.c_void_p]
    return cdll


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_phase_clocks.py needs a CUDA card")
    lib = build_clocked()
    n = 128
    s = torch_k1.rollout_states(n, torch.Generator(device="cuda").manual_seed(0), "cuda", steps=5)
    out = [torch.empty_like(x) for x in s]
    consts = torch.as_tensor(engine.kernel_constants(), device="cuda")
    clocks = np.zeros(N_CLOCKS, np.int64)
    for _ in range(3):  # the last launch's clocks: warm caches
        rc = lib.serl_control_step(*(x.data_ptr() for x in s), *(x.data_ptr() for x in out),
                                   consts.data_ptr(), None, 0, n, None)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        count = lib.serl_read_clocks(clocks.ctypes.data)
    # the load phase, then 10 substeps of equal phases, then the store phase
    steps = int(engine.kernel_constants()[-1])
    per = (count - 2) // steps
    cycles = np.diff(clocks[:count])[: per * steps].reshape(steps, per)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"K1, {n} envs: cycles per phase of a substep (median of "
          f"{steps}): {np.median(cycles, 0).astype(int).tolist()}; per substep "
          f"{int(np.median(cycles.sum(1)))}; a control step {int(clocks[count - 1] - clocks[0])} "
          f"[{card}]")


if __name__ == "__main__":
    main()
