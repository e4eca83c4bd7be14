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
// wide flag, successor flag, stacked flag) per field, and each field gets its
// own range of blocks. Two copy paths:
//   * wide rows (kWideRowBytes or more: the image frames): one block per
//     (output row, frame) task. Its threads resolve the task's slot alike
//     (the same few loads of s2 and ep_id, which the cache broadcasts), then
//     copy the row in 16-byte units (uint4) where the row bytes and both
//     addresses allow it, else in 4-byte words, else bytes, each thread with
//     kUnroll loads in flight before its stores;
//   * narrow rows (the state path's fields; the pixel path's state, actions,
//     rewards, masks, dones): one thread per 4-byte word (one byte where the
//     row or an address does not allow words) of one output row, so that a
//     warp covers many rows and neighbouring threads copy neighbouring words.
// An index outside [0, slots) fills the row with 0xFF bytes (NaN for fp32)
// instead of reading outside the ring, since checking values on the host
// would need a sync.
//
// What bounds it: bytes. At the pixel path's sample (1024 rows, two 128x128x3
// uint8 frames per obs and per next_obs) it moves ~403 MB, frames in and out,
// ~120 us at the H100's data-sheet 3.35 TB/s; the previous design (a thread
// per 4 bytes, each running the whole index chain) reached 21% of that rate
// on an NVIDIA H100 80GB HBM3 at 700 W. The state path's
// sample (2048 rows of 27 floats) is ~0.45 MB, below a launch's own latency,
// which one launch for all fields keeps to a minimum.
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
constexpr int64_t kWideRowBytes = 1024;
constexpr int kUnroll = 4;

struct FieldTable {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int64_t row_bytes[kMaxFields];
  int64_t block_start[kMaxFields + 1];
  int unit[kMaxFields];  // 16, 4 or 1 bytes
  int wide[kMaxFields];
  int successor[kMaxFields];
  int stacked[kMaxFields];
  int n_fields;
};

struct Ring {
  const int64_t* __restrict__ s2;     // (R, streams)
  const int32_t* __restrict__ ep_id;  // (slots, streams)
  int slots, streams, rows_per_stream, stack;
};

__device__ __forceinline__ int64_t wrap(int64_t s, int slots) {
  s %= slots;
  return s < 0 ? s + slots : s;
}

// The ring row (slot * streams + stream) that frame `frame` of output row o
// of field f reads, or -1 where the row's slot index is out of range.
__device__ __forceinline__ int64_t source_row(const FieldTable& t, int f, const Ring& g,
                                              int64_t o, int frame, int frames) {
  const int j = (int)(o / g.rows_per_stream);
  const int r = (int)(o - (int64_t)j * g.rows_per_stream);
  int64_t s = g.s2[(int64_t)r * g.streams + j];
  if (s < 0 || s >= g.slots) return -1;
  const int32_t ep_s = g.ep_id[s * g.streams + j];
  int32_t anchor_ep = ep_s;
  if (t.successor[f]) {
    const int64_t nxt = (s + 1) % g.slots;
    if (g.ep_id[nxt * g.streams + j] == ep_s) s = nxt;
    anchor_ep = g.ep_id[s * g.streams + j];
  }
  if (frames > 1) {
    int64_t slot = wrap(s - (frames - 1 - frame), g.slots);
    if (g.ep_id[slot * g.streams + j] != anchor_ep) {
      // the stack's first frame of the anchor's episode
      for (int k = 0; k < frames; ++k) {
        slot = wrap(s - (frames - 1 - k), g.slots);
        if (g.ep_id[slot * g.streams + j] == anchor_ep) break;
      }
    }
    s = slot;
  }
  return s * g.streams + j;
}

template <class T>
__device__ __forceinline__ T all_ones();
template <>
__device__ __forceinline__ uint4 all_ones<uint4>() {
  return make_uint4(~0u, ~0u, ~0u, ~0u);
}
template <>
__device__ __forceinline__ uint32_t all_ones<uint32_t>() {
  return ~0u;
}
template <>
__device__ __forceinline__ uint8_t all_ones<uint8_t>() {
  return 0xFF;
}

// The block copies `units` units of T from src to dst (src null: 0xFF fill),
// each thread kUnroll loads ahead of its stores.
template <class T>
__device__ __forceinline__ void copy_row(const uint8_t* src, uint8_t* dst, int64_t units) {
  const T* __restrict__ s = reinterpret_cast<const T*>(src);
  T* __restrict__ d = reinterpret_cast<T*>(dst);
  for (int64_t base = threadIdx.x; base < units; base += kUnroll * kThreadsPerBlock) {
    T v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = base + k * kThreadsPerBlock;
      if (u < units) v[k] = s != nullptr ? s[u] : all_ones<T>();
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = base + k * kThreadsPerBlock;
      if (u < units) d[u] = v[k];
    }
  }
}

__global__ void __launch_bounds__(kThreadsPerBlock)
    replay_gather_kernel(FieldTable t, Ring g) {
  int f = 0;
  while (f + 1 < t.n_fields && blockIdx.x >= t.block_start[f + 1]) ++f;
  const int frames = t.stacked[f] ? g.stack : 1;
  const int64_t row_bytes = t.row_bytes[f];
  const int64_t b = blockIdx.x - t.block_start[f];
  if (t.wide[f]) {  // block b copies output row b / frames, frame b % frames
    const int64_t o = b / frames;
    const int64_t src_row = source_row(t, f, g, o, (int)(b - o * frames), frames);
    const uint8_t* src = src_row < 0 ? nullptr : t.src[f] + src_row * row_bytes;
    uint8_t* dst = t.dst[f] + b * row_bytes;
    if (t.unit[f] == 16)
      copy_row<uint4>(src, dst, row_bytes / 16);
    else if (t.unit[f] == 4)
      copy_row<uint32_t>(src, dst, row_bytes / 4);
    else
      copy_row<uint8_t>(src, dst, row_bytes);
    return;
  }
  const int unit = t.unit[f];
  const int64_t units_per_row = row_bytes / unit;
  const int64_t i = b * kThreadsPerBlock + threadIdx.x;
  const int64_t rows = (int64_t)g.streams * g.rows_per_stream;
  if (i >= rows * frames * units_per_row) return;
  const int64_t frame_row = i / units_per_row;  // o * frames + frame
  const int64_t u = i - frame_row * units_per_row;
  const int64_t o = frame_row / frames;  // output row j * R + r
  const int64_t src_row = source_row(t, f, g, o, (int)(frame_row - o * frames), frames);
  uint8_t* dst = t.dst[f] + frame_row * row_bytes + u * unit;
  if (src_row < 0) {
    for (int k = 0; k < unit; ++k) dst[k] = 0xFF;
    return;
  }
  const uint8_t* src = t.src[f] + src_row * row_bytes + u * unit;
  if (unit == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
    for (int k = 0; k < unit; ++k) dst[k] = src[k];
  }
}

// The widest unit in {16, 4, 1} bytes (at most `widest`) that divides the
// row and both base addresses.
int copy_unit(int64_t row_bytes, const void* src, const void* dst, int widest) {
  for (int unit : {16, 4}) {
    if (unit <= widest && row_bytes % unit == 0 && (uintptr_t)src % unit == 0 &&
        (uintptr_t)dst % unit == 0)
      return unit;
  }
  return 1;
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
    t.wide[f] = row_bytes[f] >= kWideRowBytes;
    t.unit[f] = copy_unit(row_bytes[f], src[f], dst[f], t.wide[f] ? 16 : 4);
    const int64_t tasks = rows * (stacked[f] ? stack : 1);
    t.block_start[f] = blocks;
    blocks += t.wide[f] ? tasks
                        : (tasks * (row_bytes[f] / t.unit[f]) + kThreadsPerBlock - 1) /
                              kThreadsPerBlock;
  }
  t.block_start[n_fields] = blocks;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Ring g = {s2, ep_id, slots, streams, rows_per_stream, stack};
  replay_gather_kernel<<<(unsigned)blocks, kThreadsPerBlock, 0, (cudaStream_t)stream>>>(t, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
