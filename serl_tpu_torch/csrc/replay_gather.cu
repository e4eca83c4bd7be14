// CUDA kernel for the stream-aligned replay gather of the state path (K4).
//
// Replaces: serl_tpu/data/replay_buffer.py::_gather_batch_aligned, with
// _gather_aligned and _epid_aligned, for flat float32 fields: from a
// (slots, streams, width) ring it writes out[j*R + r] = buf[s2[r, j], j] for
// every field, and, when next_observations is not stored, the successor row
// of observations, (s2 + 1) % slots, falling back to s2 where ep_id says the
// successor belongs to another episode.
//
// Design: one launch gathers every field. Each thread writes one output
// float (grid.y = field, grid.x over rows x width): it reads its row's slot
// index, for a successor field the two ep_ids, and one float. Neighbouring
// threads write neighbouring floats, so the stores coalesce; the loads of a
// row's width-10 obs are contiguous too.
//
// What bounds it: the main path's call moves ~0.45 MB (2048 rows of 27
// floats read and written, plus the indices), ~0.13 us at 3.35 TB/s; the
// launch costs more than that, so it is bound by launch latency, which one
// launch for all fields keeps to a minimum. An index outside [0, slots)
// writes NaN instead of reading outside the buffer.
//
// C ABI (bound with ctypes): serl_replay_gather takes arrays of n_fields
// source and destination pointers, widths and successor flags, the (R,
// streams) int64 slot indices, the (slots, streams) int32 episode ids, the
// sizes and the CUDA stream; it returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kThreadsPerBlock = 256;

struct FieldTable {
  const float* src[kMaxFields];
  float* dst[kMaxFields];
  int width[kMaxFields];
  int successor[kMaxFields];
};

__global__ void replay_gather_kernel(FieldTable t, const int64_t* __restrict__ s2,
                                     const int32_t* __restrict__ ep_id, int slots, int streams,
                                     int rows_per_stream) {
  const int f = blockIdx.y;
  const int width = t.width[f];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)streams * rows_per_stream * width) return;
  const int o = (int)(i / width);  // output row j * R + r
  const int c = (int)(i - (int64_t)o * width);
  const int j = o / rows_per_stream;
  const int r = o - j * rows_per_stream;
  int64_t s = s2[(int64_t)r * streams + j];
  if (s < 0 || s >= slots) {
    t.dst[f][i] = nanf("");
    return;
  }
  if (t.successor[f]) {
    const int64_t nxt = (s + 1) % slots;
    if (ep_id[nxt * streams + j] == ep_id[s * streams + j]) s = nxt;
  }
  t.dst[f][i] = t.src[f][(s * streams + j) * width + c];
}

}  // namespace

extern "C" {

int serl_replay_gather_max_fields() { return kMaxFields; }

const char* serl_replay_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int serl_replay_gather(const float* const* src, float* const* dst, const int* width,
                       const int* successor, int n_fields, const int64_t* s2,
                       const int32_t* ep_id, int slots, int streams, int rows_per_stream,
                       void* stream) {
  if (n_fields <= 0 || n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
  FieldTable t = {};
  int max_width = 0;
  for (int f = 0; f < n_fields; ++f) {
    t.src[f] = src[f];
    t.dst[f] = dst[f];
    t.width[f] = width[f];
    t.successor[f] = successor[f];
    if (width[f] > max_width) max_width = width[f];
  }
  const int64_t n = (int64_t)streams * rows_per_stream * max_width;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((n + kThreadsPerBlock - 1) / kThreadsPerBlock), (unsigned)n_fields);
  replay_gather_kernel<<<grid, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(
      t, s2, ep_id, slots, streams, rows_per_stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
