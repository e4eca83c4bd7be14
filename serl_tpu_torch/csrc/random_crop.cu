// CUDA kernel for DrQ's random crop (K3).
//
// Replaces: serl_tpu/vision/augmentations.py::batched_random_crop (with
// _crop_indices), which the JAX package computes as one-hot bf16 matmuls
// only because TPU gathers scalarise. The function is a gather:
//   out[b, i, j, :] = in[b, clip(i + dy_b - pad, 0, H-1), clip(j + dx_b - pad, 0, W-1), :]
// with (dy_b, dx_b) = offsets[b] in [0, 2 pad]; it is exact for any dtype,
// since it copies bytes.
//
// Design: an output row is one source row shifted by (dx_b - pad) pixels
// with edge replication, so a block crops a tile of rows (12 KB of source,
// 32 rows of DrQ's 384-byte frames) as a row shift: it stages the clamped
// source rows in shared memory with 16-byte loads (four in flight a
// thread), writes the replicated edge pixels beside them, and writes each
// output row as 16-byte stores, coalesced across the warp, each assembled
// from two aligned 16-byte shared-memory reads by funnel shifts. Rows or
// bases that are not 16-byte aligned take the same code in 4-byte words or
// bytes (random_crop.cuh::pick_unit). One launch crops up to kMaxJobs
// same-shaped image batches (DrQ's obs and next_obs of every image key),
// grid.y = job. Offsets are a device tensor, so there is no host sync. The
// per-thread code is random_crop.cuh, which tests/k3_host.cpp also builds
// for the CPU.
//
// What bounds it: bytes. Each output byte is written once and each input
// byte read about once: 2 x 50.3 MB per (1024, 128, 128, 3) uint8 batch,
// ~30 us at 3.35 TB/s.
//
// C ABI (bound with ctypes): serl_random_crop takes arrays of n_jobs source
// images, outputs and (B, 2) int64 offsets, n_jobs, B, H, W, the bytes per
// pixel, the padding and the CUDA stream; it returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, with no launch, for a row too
// wide for shared memory). serl_random_crop_unit reports the unit a call
// with these pointers takes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "random_crop.cuh"

namespace {

using namespace serl_crop;

constexpr int kThreadsPerBlock = 256;

template <int UNIT>
__global__ void __launch_bounds__(kThreadsPerBlock) random_crop_kernel(Jobs jobs, Shape s) {
  extern __shared__ uint4 smem_words[];
  __shared__ Row rows[kMaxTileRows];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  const int job = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * s.tile_rows;
  const int n_rows = (int)min((int64_t)s.tile_rows, s.rows - row0);
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x)
    row_table(s, jobs.offsets[job], row0, r, rows);
  __syncthreads();
  stage_rows<UNIT>(s, jobs.src[job], rows, n_rows, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  fill_pads(s, n_rows, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  emit_rows<UNIT>(s, jobs.dst[job], rows, n_rows, smem, threadIdx.x, blockDim.x);
}

template <int UNIT>
void launch(const Jobs& jobs, const Shape& s, int n_jobs, cudaStream_t stream) {
  const dim3 grid((unsigned)((s.rows + s.tile_rows - 1) / s.tile_rows), (unsigned)n_jobs);
  random_crop_kernel<UNIT><<<grid, kThreadsPerBlock, s.tile_rows * s.slot, stream>>>(jobs, s);
}

}  // namespace

extern "C" {

int serl_random_crop_max_jobs() { return kMaxJobs; }

const char* serl_random_crop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int serl_random_crop_unit(const uint8_t* const* src, uint8_t* const* dst, int n_jobs, int w,
                          int pixel_bytes) {
  return pick_unit(w * pixel_bytes, src, dst, n_jobs);
}

int serl_random_crop(const uint8_t* const* src, uint8_t* const* dst,
                     const int64_t* const* offsets, int n_jobs, int batch, int h, int w,
                     int pixel_bytes, int pad, void* stream) {
  if (n_jobs <= 0 || n_jobs > kMaxJobs || h <= 0 || w <= 0 || pixel_bytes <= 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const Shape s = make_shape(batch, h, w, pixel_bytes, pad);
  if (s.tile_rows <= 0) return (int)cudaErrorInvalidValue;
  Jobs jobs = {};
  for (int j = 0; j < n_jobs; ++j) {
    jobs.src[j] = src[j];
    jobs.dst[j] = dst[j];
    jobs.offsets[j] = offsets[j];
  }
  switch (pick_unit(s.row_bytes, src, dst, n_jobs)) {
    case 16:
      launch<16>(jobs, s, n_jobs, (cudaStream_t)stream);
      break;
    case 4:
      launch<4>(jobs, s, n_jobs, (cudaStream_t)stream);
      break;
    default:
      launch<1>(jobs, s, n_jobs, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
