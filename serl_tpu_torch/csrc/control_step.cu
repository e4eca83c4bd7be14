// CUDA kernel for one 20 ms control step of N Panda + gripper + cube envs.
//
// Replaces: serl_tpu/envs/physics/engine.py::control_step (the body is
// `substep`, with arm.py, opspace.py, gripper.py and linalg_small.py), the
// hot path that the JAX package has XLA fuse into one TPU program.
//
// Design: one thread per env; the env's 37 state floats and all per-substep
// intermediates (7x7 mass matrix, 6x7 Jacobian, 6x6 task-space inertia,
// Cholesky factors) live in registers and thread-local memory; all 10
// substeps run inside one launch, so the state is read from and written to
// device memory once per control step. Strict fp32 (no fast-math); clamps
// and the "clamped == q" velocity kill use fminf/fmaxf like torch.clamp.
// The arithmetic is in control_step.cuh, shared with no other code path.
//
// What bounds it: per env a control step is ~1.4e5 fp32 operations against
// 2 x 37 x 4 bytes of state traffic, so operations, not bytes, give its
// bound. Its time is far above that bound and nearly flat in N: each thread
// walks one long serial dependency chain (register-capped at 255, with a
// small spill), and the 128 envs of the main path fill 4 warps on 4 of the
// 132 SMs, so latency, not throughput, sets the time. Spreading one env's
// substep across a warp (the 7x7 and 6x6 algebra is parallel) is the way to
// a faster kernel, and later work.
//
// C ABI (bound with ctypes): serl_control_step takes the 11 input and the 11
// output PhysicsState fields (contiguous fp32, shapes (N,7)/(N,)/(N,3)/(N,4)),
// the constant buffer (serl_control_step_constant_count() floats), N and the
// CUDA stream; it returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "control_step.cuh"

namespace {

constexpr int kThreadsPerBlock = 32;  // one warp per block spreads few envs over many SMs

__global__ void control_step_kernel(serl::Fields in, serl::Fields out,
                                    const float* __restrict__ consts, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) serl::control_step_env(in, out, consts, e);
}

}  // namespace

extern "C" {

int serl_control_step_constant_count() { return serl::C_COUNT; }

const char* serl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int serl_control_step(const float* qpos, const float* qvel, const float* theta,
                      const float* dtheta, const float* grip_ctrl, const float* mocap_pos,
                      const float* mocap_quat, const float* cube_pos, const float* cube_quat,
                      const float* cube_linvel, const float* cube_angvel, float* out_qpos,
                      float* out_qvel, float* out_theta, float* out_dtheta,
                      float* out_grip_ctrl, float* out_mocap_pos, float* out_mocap_quat,
                      float* out_cube_pos, float* out_cube_quat, float* out_cube_linvel,
                      float* out_cube_angvel, const float* consts, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  serl::Fields in = {const_cast<float*>(qpos),        const_cast<float*>(qvel),
                     const_cast<float*>(theta),       const_cast<float*>(dtheta),
                     const_cast<float*>(grip_ctrl),   const_cast<float*>(mocap_pos),
                     const_cast<float*>(mocap_quat),  const_cast<float*>(cube_pos),
                     const_cast<float*>(cube_quat),   const_cast<float*>(cube_linvel),
                     const_cast<float*>(cube_angvel)};
  serl::Fields out = {out_qpos,      out_qvel,       out_theta,     out_dtheta,
                      out_grip_ctrl, out_mocap_pos,  out_mocap_quat, out_cube_pos,
                      out_cube_quat, out_cube_linvel, out_cube_angvel};
  const int blocks = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  control_step_kernel<<<blocks, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(in, out, consts, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
