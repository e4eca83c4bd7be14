// CUDA kernel for the raycast renderer of the pixel path (K2).
//
// Replaces: serl_tpu/envs/rendering.py::render_cameras (with build_scene,
// render_scene and _render_plane/_sphere/_capsule/_box), which the JAX
// package has XLA fuse into one program over (env, pixel) lanes.
//
// Design: two kernels in one call, from the physics state to both cameras'
// frames, with no host work but allocating the outputs and a scratch row:
//   * render_scene_kernel, a warp per env: the block copies the constant row
//     (rendering.py::kernel_constants) and the env's state into shared
//     memory; seven lanes take the joint angles' cosines and sines; three
//     lanes compute the env's scene row (FK, pinch frame, pad kinematics,
//     cube rotation, wrist camera; render.cuh::scene_lane); 24 lanes compute
//     both cameras' invariants (what every pixel of a camera shares: each
//     sphere's and each capsule's first offset from the camera, each box's
//     slab bounds); the row and the invariants go to the scratch row (and
//     the scene row to the debug output when it is given);
//   * render_pixels_kernel, a thread per pixel (grid.z = env, grid.y =
//     camera, grid.x over 256-pixel tiles): the block copies its env's scene
//     row, its camera's invariants and the render constants into shared
//     memory (one round trip), each thread renders its pixel
//     (render.cuh::render_pixel) from broadcast shared memory into a staged
//     tile of RGB bytes, and the tile goes out as 16-byte stores (bytes
//     where the tile is not 16-byte aligned).
// One kernel that computed the scene in each block was measured slower:
// its serial prologue on a few lanes ran once per block, and its registers
// (the FK's) held every block's pixels to a third of the SM; the scene
// kernel runs it once per env, and the pixel kernel needs ~38 registers.
// The (gx, gy) grid comes from the caller, built with np.linspace in
// float32 as the JAX package builds it: recomputing it here would round
// differently and move every ray. Reciprocals are __frcp_rn (correctly
// rounded, the IEEE quotient 1 / x) and the checker parity is exact, so
// the per-pixel code rounds where the plain version rounds except where
// nvcc contracts a multiply and an add: this file takes the general
// -fmad=true (native/build.py), which passes the pixel rule of
// tests/torch_k2.py at every input of chip_smoke.py and is the faster of
// the two builds there (PERF.md); g++'s host build keeps
// -ffp-contract=off and stays exact.
//
// What bounds it: fp32 operations against 3 bytes written per pixel. The
// code's own count (tests/k2_host.cpp) is per pixel, per (env, camera) and
// per env; chip_smoke.py prints it beside the unhoisted count, with every
// camera invariant done once per pixel (1,287 operations a pixel).
// The work per pixel has no data-dependent loop, so warps diverge only at
// the hit selects; what holds it above its bound is instruction issue: each
// IEEE division and square root is several instructions, and the selects,
// compares and shared-memory operands are not operations of the count.
//
// C ABI (bound with ctypes): serl_render_cameras takes the env state's qpos
// (N, 7), theta (N), cube_pos (N, 3) and cube_quat (N, 4), the constant row
// (its length must equal C_COUNT), the (2 cameras, 2, P) pixel grid, the two
// (N, P, 3) uint8 outputs (front, wrist), an (N, serl_render_work_floats())
// fp32 scratch, an (N, SCENE_FLOATS) fp32 output for the scene rows or null
// (a debug output: written only when given), N, P, the constant row's
// length and the CUDA stream; it returns cudaGetLastError() after the two
// launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "render.cuh"

namespace {

using namespace serl_render;

constexpr int kTilePixels = 256;  // a thread per pixel
// an env's scene row, then its two cameras' invariants
constexpr int kWorkFloats = SCENE_FLOATS + 2 * INV_FLOATS;

// One block (a warp) per env: the scene row and both cameras' invariants
// into work (and the row into scene_out, when given).
__global__ void __launch_bounds__(32)
    render_scene_kernel(const float* __restrict__ qpos, const float* __restrict__ theta,
                        const float* __restrict__ cube_pos, const float* __restrict__ cube_quat,
                        const float* __restrict__ consts, float* __restrict__ work,
                        float* __restrict__ scene_out) {
  __shared__ float s_c[C_COUNT];
  __shared__ float s_state[15];  // qpos 7, theta, cube_pos 3, cube_quat 4
  __shared__ float s_trig[14];
  __shared__ float s_work[kWorkFloats];
  const int env = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < C_COUNT; i += 32) s_c[i] = consts[i];
  if (lane < 7)
    s_state[lane] = qpos[7 * env + lane];
  else if (lane == 7)
    s_state[7] = theta[env];
  else if (lane < 11)
    s_state[lane] = cube_pos[3 * env + lane - 8];
  else if (lane < 15)
    s_state[lane] = cube_quat[4 * env + lane - 11];
  __syncwarp();
  if (lane < 7) joint_trig(lane, s_state, s_trig);
  __syncwarp();
  if (lane < 3) scene_lane(lane, s_trig, s_state[7], s_state + 8, s_state + 11, s_c, s_work);
  __syncwarp();
  if (lane < 2 * INV_TASKS)
    camera_invariants(lane % INV_TASKS, s_work, lane / INV_TASKS,
                      s_work + SCENE_FLOATS + (lane / INV_TASKS) * INV_FLOATS);
  __syncwarp();
  for (int i = lane; i < kWorkFloats; i += 32) work[(long long)env * kWorkFloats + i] = s_work[i];
  if (scene_out != nullptr)
    for (int i = lane; i < SCENE_FLOATS; i += 32)
      scene_out[(long long)env * SCENE_FLOATS + i] = s_work[i];
}

// A tile of kTilePixels pixels of one (env, camera) from the env's work row
__global__ void __launch_bounds__(kTilePixels)
    render_pixels_kernel(const float* __restrict__ work, const float* __restrict__ consts,
                         const float* __restrict__ grid, unsigned char* __restrict__ front,
                         unsigned char* __restrict__ wrist, int pixels) {
  __shared__ float s_scene[SCENE_FLOATS];
  __shared__ float s_inv[INV_FLOATS];
  __shared__ float s_k[K_COUNT];
  __shared__ __align__(16) unsigned char s_rgb[3 * kTilePixels];
  const int env = blockIdx.z;
  const int cam = blockIdx.y;
  const int p0 = blockIdx.x * kTilePixels;
  const int tid = threadIdx.x;
  const float* row = work + (long long)env * kWorkFloats;
  if (tid < SCENE_FLOATS)
    s_scene[tid] = row[tid];
  else if (tid < SCENE_FLOATS + K_COUNT)
    s_k[tid - SCENE_FLOATS] = consts[C_RENDER + tid - SCENE_FLOATS];
  if (tid < INV_FLOATS) s_inv[tid] = row[SCENE_FLOATS + cam * INV_FLOATS + tid];
  __syncthreads();
  const int count = min(kTilePixels, pixels - p0);
  const float* gx = grid + (2 * cam) * pixels + p0;
  if (tid < count) render_pixel(s_scene, s_inv, cam, s_k, gx[tid], gx[pixels + tid], s_rgb + 3 * tid);
  __syncthreads();
  unsigned char* out = (cam == 0 ? front : wrist) + ((long long)env * pixels + p0) * 3;
  const int bytes = 3 * count;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0 && bytes % 16 == 0) {
    for (int i = tid; i < bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(s_rgb)[i];
  } else {
    for (int i = tid; i < bytes; i += blockDim.x) out[i] = s_rgb[i];
  }
}

}  // namespace

extern "C" {

int serl_render_scene_floats() { return SCENE_FLOATS; }

int serl_render_constant_count() { return C_COUNT; }

int serl_render_work_floats() { return kWorkFloats; }

const char* serl_render_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int serl_render_cameras(const float* qpos, const float* theta, const float* cube_pos,
                        const float* cube_quat, const float* consts, const float* grid,
                        unsigned char* front, unsigned char* wrist, float* work,
                        float* scene_out, int n, int pixels, int const_count, void* stream) {
  if (const_count != C_COUNT || n > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0 || pixels <= 0) return (int)cudaSuccess;
  render_scene_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(qpos, theta, cube_pos, cube_quat,
                                                          consts, work, scene_out);
  const dim3 grid_dim((unsigned)((pixels + kTilePixels - 1) / kTilePixels), 2u, (unsigned)n);
  render_pixels_kernel<<<grid_dim, kTilePixels, 0, (cudaStream_t)stream>>>(
      work, consts, grid, front, wrist, pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
