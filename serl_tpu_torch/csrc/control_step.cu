// CUDA kernel for one 20 ms control step of N Panda + gripper + cube envs.
//
// Replaces: serl_tpu/envs/physics/engine.py::control_step (the body is
// `substep`, with arm.py, opspace.py, gripper.py and linalg_small.py), the
// hot path that the JAX package has XLA fuse into one TPU program.
//
// Design: a group of 16 lanes (half a warp) per env splits each substep's
// work (control_step.cuh says how). The env's state and every intermediate
// live in shared memory; the block copies the constant buffer into shared
// memory once, so the substeps read nothing from device memory. All 10
// substeps run inside one launch: the state is read and written once per
// control step. Strict fp32 (no fast-math); clamps and the "clamped == q"
// velocity kill use fminf/fmaxf like torch.clamp; no atomics, so two launches
// on one input agree bit for bit.
//
// What bounds it: per env a control step is ~8.5e4 fp32 operations against
// 2 x 37 x 4 bytes of state traffic, so operations give its bound, ~2.6 us
// for 2,048 envs at the H100 SXM's data-sheet fp32 rate (67 TFLOP/s). It
// runs far above that bound: one env's step is a chain of 160 phases, each
// as long as the sum of its divergent code paths' latencies plus a sync, so
// latency, not throughput, sets the time. Half a warp per env lets a warp
// issue two envs' single-lane tasks at once. The previous design ran the
// whole chain on one thread per env: 0.43 ms a launch at 128 and at 2,048
// envs on an NVIDIA H100 80GB HBM3 at 700 W.
//
// Static obstacles (engine.py::_obstacle_contact, the bin walls): an (M, 2,
// 3) table of boxes that every env shares, M <= kMaxObstacles. The block
// copies it into shared memory beside the constants. Each of the 8 cube
// corners' contacts with the boxes is one task (serial over the boxes, in
// order) on the lanes that the floor corners' round leaves idle, and the
// corners' sums join the floor's force and torque in the next phase. M = 0
// (a null table) skips both: a launch without obstacles equals, bit for bit,
// the kernel built with SERL_NO_OBSTACLES (no obstacle code at all).
//
// C ABI (bound with ctypes): serl_control_step takes the 11 input and the 11
// output PhysicsState fields (contiguous fp32, shapes (N,7)/(N,)/(N,3)/(N,4)),
// the constant buffer (serl_control_step_constant_count() floats), the
// obstacle table (6 M floats; null when M = 0), M, N and the CUDA stream; it
// returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

#include "control_step.cuh"

namespace {

constexpr int kThreadsPerBlock = 64;
constexpr int kEnvsPerBlock = kThreadsPerBlock / serl::kGroupLanes;
constexpr int kMaxObstacles = 8;

// 8 blocks a SM: 2,048 envs are one wave on the card's 132 SMs
__global__ void __launch_bounds__(kThreadsPerBlock, 8)
    control_step_kernel(serl::Fields in, serl::Fields out, const float* __restrict__ consts,
                        const float* __restrict__ obstacles, int m, int n) {
  __shared__ float C[serl::C_COUNT];
  __shared__ float O[6 * kMaxObstacles];
  __shared__ serl::Group groups[kEnvsPerBlock];
  for (int k = threadIdx.x; k < serl::C_COUNT; k += kThreadsPerBlock) C[k] = consts[k];
  for (int k = threadIdx.x; k < 6 * m; k += kThreadsPerBlock) O[k] = obstacles[k];
  __syncthreads();
  const int w = threadIdx.x / serl::kGroupLanes;
  const int e = blockIdx.x * kEnvsPerBlock + w;
  if (e < n) serl::control_step_env(in, out, C, O, m, e, groups[w]);
}

}  // namespace

extern "C" {

int serl_control_step_constant_count() { return serl::C_COUNT; }

int serl_control_step_max_obstacles() { return kMaxObstacles; }

const char* serl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int serl_control_step(const float* qpos, const float* qvel, const float* theta,
                      const float* dtheta, const float* grip_ctrl, const float* mocap_pos,
                      const float* mocap_quat, const float* cube_pos, const float* cube_quat,
                      const float* cube_linvel, const float* cube_angvel, float* out_qpos,
                      float* out_qvel, float* out_theta, float* out_dtheta,
                      float* out_grip_ctrl, float* out_mocap_pos, float* out_mocap_quat,
                      float* out_cube_pos, float* out_cube_quat, float* out_cube_linvel,
                      float* out_cube_angvel, const float* consts, const float* obstacles,
                      int m, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (m < 0 || m > kMaxObstacles || (m > 0 && obstacles == nullptr))
    return (int)cudaErrorInvalidValue;
  serl::Fields in = {const_cast<float*>(qpos),        const_cast<float*>(qvel),
                     const_cast<float*>(theta),       const_cast<float*>(dtheta),
                     const_cast<float*>(grip_ctrl),   const_cast<float*>(mocap_pos),
                     const_cast<float*>(mocap_quat),  const_cast<float*>(cube_pos),
                     const_cast<float*>(cube_quat),   const_cast<float*>(cube_linvel),
                     const_cast<float*>(cube_angvel)};
  serl::Fields out = {out_qpos,      out_qvel,       out_theta,     out_dtheta,
                      out_grip_ctrl, out_mocap_pos,  out_mocap_quat, out_cube_pos,
                      out_cube_quat, out_cube_linvel, out_cube_angvel};
  control_step_kernel<<<(n + kEnvsPerBlock - 1) / kEnvsPerBlock, kThreadsPerBlock, 0,
                        (cudaStream_t)stream>>>(in, out, consts, obstacles, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
