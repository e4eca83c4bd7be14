// CUDA kernel for the raycast renderer of the pixel path (K2).
//
// Replaces: serl_tpu/envs/rendering.py::render_cameras (with build_scene,
// render_scene and _render_plane/_sphere/_capsule/_box), which the JAX
// package has XLA fuse into one program over (env, pixel) lanes.
//
// Design: one thread per (env, camera, pixel); both cameras of every env in
// one launch (grid.z = env, grid.y = camera, grid.x over pixels). Each block
// first copies its env's scene row (170 floats: two camera poses, spheres,
// capsules, boxes, colours) and the 16 render constants into shared memory,
// so the ~13 primitive tests of each pixel read broadcast shared memory, not
// device memory. The per-pixel code is render.cuh, which follows the plain
// version op by op; this file is built with -fmad=false (native/build.py)
// so that the kernel rounds where the plain version rounds. The (gx, gy)
// grid comes from the caller, built with np.linspace in float32 as the JAX
// package builds it: recomputing it here would round differently and move
// every ray.
//
// What bounds it: ~1.3k fp32 operations per pixel (counted in the code by
// tests/k2_host.cpp) against 3 bytes written per pixel, so operations
// bound it: 2 x 16 x 16384 pixels at the main path's N = 16 is ~0.7 GFLOP,
// ~10 us at the card's 67 TFLOP/s fp32 rate, while the frames are 1.57 MB
// (~0.5 us of bandwidth). The work per pixel has no data-dependent loop, so
// warps do not diverge except at the hit selects.
//
// C ABI (bound with ctypes): serl_render_cameras takes the (N, SCENE_FLOATS)
// scene, the (2 cameras, 2, P) pixel grid, the K_COUNT constants, the two
// (N, P, 3) uint8 outputs (front, wrist), N, P, the scene row length (must
// equal SCENE_FLOATS) and the CUDA stream; it returns cudaGetLastError()
// after the launch.
#include <cuda_runtime.h>

#include "render.cuh"

namespace {

constexpr int kThreadsPerBlock = 256;

__global__ void render_kernel(const float* __restrict__ scene, const float* __restrict__ grid,
                              const float* __restrict__ consts, unsigned char* __restrict__ front,
                              unsigned char* __restrict__ wrist, int pixels) {
  __shared__ float s_scene[serl_render::SCENE_FLOATS];
  __shared__ float s_consts[serl_render::K_COUNT];
  const int env = blockIdx.z;
  const int cam = blockIdx.y;
  for (int i = threadIdx.x; i < serl_render::SCENE_FLOATS; i += blockDim.x)
    s_scene[i] = scene[(long long)env * serl_render::SCENE_FLOATS + i];
  for (int i = threadIdx.x; i < serl_render::K_COUNT; i += blockDim.x) s_consts[i] = consts[i];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const float gx = grid[(2 * cam) * pixels + p];
  const float gy = grid[(2 * cam + 1) * pixels + p];
  unsigned char rgb[3];
  serl_render::render_pixel(s_scene, cam, s_consts, gx, gy, rgb);
  unsigned char* out = (cam == 0 ? front : wrist) + ((long long)env * pixels + p) * 3;
  out[0] = rgb[0];
  out[1] = rgb[1];
  out[2] = rgb[2];
}

}  // namespace

extern "C" {

int serl_render_scene_floats() { return serl_render::SCENE_FLOATS; }

const char* serl_render_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int serl_render_cameras(const float* scene, const float* grid, const float* consts,
                        unsigned char* front, unsigned char* wrist, int n, int pixels,
                        int scene_floats, void* stream) {
  if (scene_floats != serl_render::SCENE_FLOATS || n > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0 || pixels <= 0) return (int)cudaSuccess;
  const dim3 grid_dim((unsigned)((pixels + kThreadsPerBlock - 1) / kThreadsPerBlock), 2u,
                      (unsigned)n);
  render_kernel<<<grid_dim, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(scene, grid, consts,
                                                                         front, wrist, pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
