// CUDA kernel for DrQ's random crop (K3).
//
// Replaces: serl_tpu/vision/augmentations.py::batched_random_crop (with
// _crop_indices), which the JAX package computes as one-hot bf16 matmuls
// only because TPU gathers scalarise. The function is a gather:
//   out[b, i, j, :] = in[b, clip(i + dy_b - pad, 0, H-1), clip(j + dx_b - pad, 0, W-1), :]
// with (dy_b, dx_b) = offsets[b] in [0, 2 pad]; it is exact for any dtype,
// since it copies bytes.
//
// Design: one launch crops up to kMaxJobs same-shaped image batches (DrQ's
// obs and next_obs of every image key), grid.y = job. Each thread writes one
// 4-byte word of an output row (one byte where a row is not a whole number
// of words): it reads its image's two offsets, clamps the source row once
// and the source column per byte, and reads the bytes from the source row,
// which neighbouring threads share, so the reads hit the same cache lines.
// Offsets are a device tensor, so there is no host sync.
//
// What bounds it: bytes. Each output byte is written once and each input
// byte read about once: 2 x 50.3 MB per (1024, 128, 128, 3) uint8 batch,
// ~30 us at 3.35 TB/s.
//
// C ABI (bound with ctypes): serl_random_crop takes arrays of n_jobs source
// images, outputs and (B, 2) int64 offsets, n_jobs, B, H, W, the bytes per
// pixel, the padding and the CUDA stream; it returns cudaGetLastError()
// after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxJobs = 8;
constexpr int kThreadsPerBlock = 256;

struct CropJobs {
  const uint8_t* src[kMaxJobs];
  uint8_t* dst[kMaxJobs];
  const int64_t* offsets[kMaxJobs];
};

template <int UNIT>
__global__ void random_crop_kernel(CropJobs jobs, int batch, int h, int w, int pixel_bytes,
                                   int pad) {
  const int job = blockIdx.y;
  const int row_bytes = w * pixel_bytes;
  const int row_units = row_bytes / UNIT;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)batch * h * row_units) return;
  const int u = (int)(i % row_units);
  const int64_t row = i / row_units;  // b * h + out_row
  const int b = (int)(row / h);
  const int out_row = (int)(row - (int64_t)b * h);
  const int64_t* off = jobs.offsets[job] + 2 * b;
  const int dy = (int)off[0], dx = (int)off[1];
  const int src_row = min(max(out_row + dy - pad, 0), h - 1);
  const uint8_t* src = jobs.src[job] + ((int64_t)b * h + src_row) * row_bytes;
  uint8_t bytes[UNIT];
#pragma unroll
  for (int k = 0; k < UNIT; ++k) {
    const int byte = u * UNIT + k;
    const int px = byte / pixel_bytes;
    const int within = byte - px * pixel_bytes;
    const int src_col = min(max(px + dx - pad, 0), w - 1);
    bytes[k] = src[src_col * pixel_bytes + within];
  }
  uint8_t* dst = jobs.dst[job] + row * row_bytes + u * UNIT;
  if constexpr (UNIT == 4) {
    *reinterpret_cast<uint32_t*>(dst) = (uint32_t)bytes[0] | ((uint32_t)bytes[1] << 8) |
                                        ((uint32_t)bytes[2] << 16) | ((uint32_t)bytes[3] << 24);
  } else {
    dst[0] = bytes[0];
  }
}

}  // namespace

extern "C" {

int serl_random_crop_max_jobs() { return kMaxJobs; }

const char* serl_random_crop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int serl_random_crop(const uint8_t* const* src, uint8_t* const* dst,
                     const int64_t* const* offsets, int n_jobs, int batch, int h, int w,
                     int pixel_bytes, int pad, void* stream) {
  if (n_jobs <= 0 || n_jobs > kMaxJobs || h <= 0 || w <= 0 || pixel_bytes <= 0 || pad < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  CropJobs jobs = {};
  bool aligned = (w * pixel_bytes) % 4 == 0;
  for (int j = 0; j < n_jobs; ++j) {
    jobs.src[j] = src[j];
    jobs.dst[j] = dst[j];
    jobs.offsets[j] = offsets[j];
    aligned = aligned && ((uintptr_t)dst[j] % 4 == 0);
  }
  const int unit = aligned ? 4 : 1;
  const int64_t n = (int64_t)batch * h * (w * pixel_bytes / unit);
  const dim3 grid((unsigned)((n + kThreadsPerBlock - 1) / kThreadsPerBlock), (unsigned)n_jobs);
  if (aligned)
    random_crop_kernel<4><<<grid, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(
        jobs, batch, h, w, pixel_bytes, pad);
  else
    random_crop_kernel<1><<<grid, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(
        jobs, batch, h, w, pixel_bytes, pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
