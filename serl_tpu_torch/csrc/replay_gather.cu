// CUDA kernel for the stream-aligned replay gather (K4).
//
// Replaces: serl_tpu/data/replay_buffer.py::_gather_batch_aligned, with
// _gather_aligned, _epid_aligned and _stack_obs_aligned: from
// (slots, streams, ...) rings it writes out[j*R + r] = buf[s2[r, j], j] for
// every field. A "successor" field reads the successor row instead,
// (s2 + 1) % slots, falling back to s2 where ep_id says the successor belongs
// to another episode (next_observations rebuilt from observations). A
// "stacked" field (an image key) writes T frames per row: frame t of the row
// anchored at slot a (s2, or the successor) is slot (a - (T-1-t)) mod slots
// where that slot's ep_id equals the anchor's, and otherwise the first slot
// of the stack that does (the anchor itself at the latest), so a stack never
// crosses an episode boundary.
//
// Design: one launch gathers every field of obs and next_obs, of any element
// type: the field table holds (source, destination, row bytes, copy unit,
// successor flag, stacked flag) per field, and each field gets its own range
// of blocks. Each thread copies one unit of one output row: 4 bytes where the
// row and both pointers allow it (every fp32 field, and the uint8 frames), one
// byte otherwise. It reads its row's slot index, the ep_ids its successor and
// stack rules need, and the unit. Neighbouring threads copy neighbouring
// units, so loads and stores coalesce. An index outside [0, slots) fills the
// row with 0xFF bytes (NaN for fp32) instead of reading outside the ring, since
// checking values on the host would need a sync.
//
// What bounds it: bytes. At the pixel path's sample (1024 rows, two 128x128x3
// uint8 frames per obs and per next_obs) it moves ~403 MB, frames in and out,
// ~120 us at 3.35 TB/s; the state path's sample (2048 rows of 27 floats) is
// ~0.45 MB, below a launch's own latency, which one launch for all fields
// keeps to a minimum.
//
// C ABI (bound with ctypes): serl_replay_gather takes arrays of n_fields
// source and destination pointers, row bytes, successor and stacked flags,
// the stack length T, the (R, streams) int64 slot indices, the (slots,
// streams) int32 episode ids, the sizes and the CUDA stream; it returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kThreadsPerBlock = 256;

struct FieldTable {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int64_t row_bytes[kMaxFields];
  int64_t block_start[kMaxFields + 1];
  int unit[kMaxFields];
  int successor[kMaxFields];
  int stacked[kMaxFields];
  int n_fields;
};

__device__ __forceinline__ int64_t wrap(int64_t s, int slots) {
  s %= slots;
  return s < 0 ? s + slots : s;
}

__global__ void replay_gather_kernel(FieldTable t, const int64_t* __restrict__ s2,
                                     const int32_t* __restrict__ ep_id, int slots, int streams,
                                     int rows_per_stream, int stack) {
  int f = 0;
  while (f + 1 < t.n_fields && blockIdx.x >= t.block_start[f + 1]) ++f;
  const int unit = t.unit[f];
  const int64_t units_per_row = t.row_bytes[f] / unit;
  const int frames = t.stacked[f] ? stack : 1;
  const int64_t i = (blockIdx.x - t.block_start[f]) * (int64_t)blockDim.x + threadIdx.x;
  const int64_t rows = (int64_t)streams * rows_per_stream;
  if (i >= rows * frames * units_per_row) return;
  const int64_t frame_row = i / units_per_row;  // o * frames + frame
  const int64_t u = i - frame_row * units_per_row;
  const int64_t o = frame_row / frames;  // output row j * R + r
  const int frame = (int)(frame_row - o * frames);
  const int j = (int)(o / rows_per_stream);
  const int r = (int)(o - (int64_t)j * rows_per_stream);
  uint8_t* dst = t.dst[f] + frame_row * t.row_bytes[f] + u * unit;
  int64_t s = s2[(int64_t)r * streams + j];
  if (s < 0 || s >= slots) {
    for (int k = 0; k < unit; ++k) dst[k] = 0xFF;
    return;
  }
  const int32_t ep_s = ep_id[s * streams + j];
  int32_t anchor_ep = ep_s;
  if (t.successor[f]) {
    const int64_t nxt = (s + 1) % slots;
    if (ep_id[nxt * streams + j] == ep_s) s = nxt;
    anchor_ep = ep_id[s * streams + j];
  }
  if (frames > 1) {
    int64_t slot = wrap(s - (frames - 1 - frame), slots);
    if (ep_id[slot * streams + j] != anchor_ep) {
      // the stack's first frame of the anchor's episode
      for (int k = 0; k < frames; ++k) {
        slot = wrap(s - (frames - 1 - k), slots);
        if (ep_id[slot * streams + j] == anchor_ep) break;
      }
    }
    s = slot;
  }
  const uint8_t* src = t.src[f] + (s * streams + j) * t.row_bytes[f] + u * unit;
  if (unit == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
    for (int k = 0; k < unit; ++k) dst[k] = src[k];
  }
}

}  // namespace

extern "C" {

int serl_replay_gather_max_fields() { return kMaxFields; }

const char* serl_replay_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int serl_replay_gather(const uint8_t* const* src, uint8_t* const* dst, const int64_t* row_bytes,
                       const int* successor, const int* stacked, int n_fields, int stack,
                       const int64_t* s2, const int32_t* ep_id, int slots, int streams,
                       int rows_per_stream, void* stream) {
  if (n_fields <= 0 || n_fields > kMaxFields || stack < 1 || slots <= 0)
    return (int)cudaErrorInvalidValue;
  FieldTable t = {};
  t.n_fields = n_fields;
  const int64_t rows = (int64_t)streams * rows_per_stream;
  int64_t blocks = 0;
  for (int f = 0; f < n_fields; ++f) {
    if (row_bytes[f] <= 0) return (int)cudaErrorInvalidValue;
    t.src[f] = src[f];
    t.dst[f] = dst[f];
    t.row_bytes[f] = row_bytes[f];
    t.successor[f] = successor[f];
    t.stacked[f] = stacked[f];
    const bool words = row_bytes[f] % 4 == 0 && (uintptr_t)src[f] % 4 == 0 &&
                       (uintptr_t)dst[f] % 4 == 0;
    t.unit[f] = words ? 4 : 1;
    const int64_t n = rows * (stacked[f] ? stack : 1) * (row_bytes[f] / t.unit[f]);
    t.block_start[f] = blocks;
    blocks += (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  }
  t.block_start[n_fields] = blocks;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  replay_gather_kernel<<<(unsigned)blocks, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(
      t, s2, ep_id, slots, streams, rows_per_stream, stack);
  return (int)cudaGetLastError();
}

}  // extern "C"
