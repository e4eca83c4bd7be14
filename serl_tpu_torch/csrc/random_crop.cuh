// DrQ's random crop (K3) as code for one thread of a block (see
// random_crop.cu, which launches it).
//
// The function: out[b, i, j, :] = in[b, clip(i + dy_b - pad, 0, H-1),
// clip(j + dx_b - pad, 0, W-1), :] with (dy_b, dx_b) = offsets[b] in
// [0, 2 pad]. Every output row is one source row (the row clamp) shifted by
// (dx_b - pad) pixels with edge replication at both ends, so a block crops a
// tile of output rows in four phases, each a loop over tasks that the
// block's threads share, with a block-wide sync between phases:
//
//   1. row_table: each tile row's clamped source row and its shift;
//   2. stage_rows: copy the source rows into shared memory in UNIT-byte
//      units, four loads in flight a thread, each row in a slot whose
//      `lead` bytes (the left padding rounded up to 16) come first;
//   3. fill_pads: write the edge-replicated padding beside each staged row,
//      so that the slot holds the padded row (W + 2 pad pixels);
//   4. emit_rows: the output row is the padded row's window at byte dx * C,
//      so each task reads the aligned words around its UNIT output bytes
//      from shared memory, funnel-shifts them into place and writes them
//      with one UNIT-byte store.
//
// UNIT is 16 where every row and base is 16-byte aligned (DrQ's uint8
// frames: 128 x 3 = 384-byte rows, 49,152-byte images), else 4, else 1
// (`pick_unit`); every path copies bytes, so every dtype is exact. Offsets
// outside [0, 2 pad] are outside the function's domain: the row clamp takes
// any dy, the column shift is clamped into the padded row.
//
// Nothing here is CUDA-specific beyond SERL_FN and the three primitives
// below, so the same code also compiles as host C++ (tests/k3_host.cpp runs
// the phases' tasks one after another and the CPU tests hold it against the
// plain gather).
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SERL_FN __device__ __forceinline__
#else
#define SERL_FN inline
#endif

namespace serl_crop {

constexpr int kMaxJobs = 8;
constexpr int kTileBytes = 12288;  // staged bytes a block aims at
constexpr int kMaxTileRows = 128;
constexpr int kMaxSlotBytes = 40 * 1024;  // of the 48 KB a block may use without opt-in

#ifdef __CUDACC__
SERL_FN void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
SERL_FN uint32_t funnel(uint32_t lo, uint32_t hi, int bits) {
  return __funnelshift_r(lo, hi, bits);
}
#else
inline void copy16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline uint32_t funnel(uint32_t lo, uint32_t hi, int bits) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> bits);
}
#endif

SERL_FN int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

struct Jobs {
  const uint8_t* src[kMaxJobs];
  uint8_t* dst[kMaxJobs];
  const int64_t* offsets[kMaxJobs];
};

struct Shape {
  int64_t rows;     // B * H output rows of a job
  int h;            // rows of an image
  int row_bytes;    // W * C * element size
  int pixel_bytes;  // C * element size
  int pad;
  int pad_bytes;    // pad * pixel_bytes
  int lead;         // bytes of a slot before its row: pad_bytes rounded up to 16
  int slot;         // bytes of a slot: the padded row, rounded up to 16, plus 16
                    // for the aligned reads past its end
  int tile_rows;    // rows a block crops
};

// The shape of a crop of (batch, h, w) images of pixel_bytes each; tile_rows
// is 0 where one slot does not fit in a block's shared memory.
inline Shape make_shape(int batch, int h, int w, int pixel_bytes, int pad) {
  Shape s;
  s.rows = (int64_t)batch * h;
  s.h = h;
  s.row_bytes = w * pixel_bytes;
  s.pixel_bytes = pixel_bytes;
  s.pad = pad;
  s.pad_bytes = pad * pixel_bytes;
  s.lead = (s.pad_bytes + 15) / 16 * 16;
  s.slot = (s.lead + s.row_bytes + s.pad_bytes + 15) / 16 * 16 + 16;
  const int fit = kMaxSlotBytes / s.slot;
  const int want = kTileBytes / s.slot > 1 ? kTileBytes / s.slot : 1;
  s.tile_rows = want < fit ? want : fit;
  if (s.tile_rows > kMaxTileRows) s.tile_rows = kMaxTileRows;
  if ((int64_t)s.tile_rows > s.rows) s.tile_rows = (int)s.rows;
  return s;
}

// 16 where the rows and every base allow 16-byte units, else 4, else 1
inline int pick_unit(int row_bytes, const uint8_t* const* src, uint8_t* const* dst, int n_jobs) {
  int unit = 16;
  while (unit > 1) {
    bool ok = row_bytes % unit == 0;
    for (int j = 0; j < n_jobs; ++j)
      ok = ok && (uintptr_t)src[j] % unit == 0 && (uintptr_t)dst[j] % unit == 0;
    if (ok) break;
    unit /= 4;
  }
  return unit;
}

struct Row {
  int64_t src;  // byte offset of the clamped source row in the job's images
  int64_t dst;  // byte offset of the output row
  int window;   // byte offset of the output row's window in the slot
};

// Phase 1, task r: row r of the tile that starts at output row row0
SERL_FN void row_table(const Shape& s, const int64_t* offsets, int64_t row0, int r, Row* rows) {
  const int64_t row = row0 + r;
  const int64_t b = row / s.h;
  const int i = (int)(row - b * s.h);
  const int dy = (int)offsets[2 * b];
  const int dx = clampi((int)offsets[2 * b + 1], 0, 2 * s.pad);
  rows[r].src = (b * s.h + clampi(i + dy - s.pad, 0, s.h - 1)) * (int64_t)s.row_bytes;
  rows[r].dst = row * (int64_t)s.row_bytes;
  rows[r].window = s.lead - s.pad_bytes + dx * s.pixel_bytes;
}

template <int UNIT>
struct alignas(16) Unit {
  uint32_t w[UNIT / 4];
};
template <>
struct Unit<1> {
  uint8_t b;
};

template <int UNIT>
SERL_FN void load_unit(const uint8_t* p, Unit<UNIT>& v) {
  if constexpr (UNIT == 16)
    copy16(v.w, p);
  else if constexpr (UNIT == 4)
    v.w[0] = *reinterpret_cast<const uint32_t*>(p);
  else
    v.b = *p;
}

template <int UNIT>
SERL_FN void store_unit(uint8_t* p, const Unit<UNIT>& v) {
  if constexpr (UNIT == 16)
    copy16(p, v.w);
  else if constexpr (UNIT == 4)
    *reinterpret_cast<uint32_t*>(p) = v.w[0];
  else
    *p = v.b;
}

// Phase 2: the tile's `n_rows` source rows into their slots, the tasks
// tid, tid + threads, ... of this thread, four loads in flight
template <int UNIT>
SERL_FN void stage_rows(const Shape& s, const uint8_t* src, const Row* rows, int n_rows,
                        uint8_t* smem, int tid, int threads) {
  const int units = s.row_bytes / UNIT;
  const int n = n_rows * units;
  for (int t0 = tid; t0 < n; t0 += 4 * threads) {
    Unit<UNIT> v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k * threads;
      if (t < n) {
        const int r = t / units, u = t - r * units;
        load_unit<UNIT>(src + rows[r].src + u * UNIT, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k * threads;
      if (t < n) {
        const int r = t / units, u = t - r * units;
        store_unit<UNIT>(smem + r * s.slot + s.lead + u * UNIT, v[k]);
      }
    }
  }
}

// Phase 3: pad_bytes copies of the first pixel's bytes before each staged
// row and of the last pixel's after it
SERL_FN void fill_pads(const Shape& s, int n_rows, uint8_t* smem, int tid, int threads) {
  const int per_row = 2 * s.pad_bytes;
  for (int t = tid; t < n_rows * per_row; t += threads) {
    const int r = t / per_row;
    const int k = t - r * per_row;
    uint8_t* row = smem + r * s.slot + s.lead;
    if (k < s.pad_bytes)
      row[k - s.pad_bytes] = row[k % s.pixel_bytes];
    else
      row[s.row_bytes + k - s.pad_bytes] =
          row[s.row_bytes - s.pixel_bytes + (k - s.pad_bytes) % s.pixel_bytes];
  }
}

// UNIT bytes of a slot at byte offset o (any alignment), from aligned reads
template <int UNIT>
SERL_FN void window_unit(const uint8_t* slot, int o, Unit<UNIT>& v) {
  if constexpr (UNIT == 16) {
    alignas(16) uint32_t x[8];
    copy16(x, slot + (o & ~15));
    copy16(x + 4, slot + (o & ~15) + 16);
    const int q = (o & 15) >> 2, bits = (o & 3) * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = q == 0 ? x[j] : q == 1 ? x[j + 1] : q == 2 ? x[j + 2] : x[j + 3];
      const uint32_t hi = q == 0 ? x[j + 1] : q == 1 ? x[j + 2] : q == 2 ? x[j + 3] : x[j + 4];
      v.w[j] = funnel(lo, hi, bits);
    }
  } else if constexpr (UNIT == 4) {
    const uint32_t* x = reinterpret_cast<const uint32_t*>(slot + (o & ~3));
    v.w[0] = funnel(x[0], x[1], (o & 3) * 8);
  } else {
    v.b = slot[o];
  }
}

// Phase 4: the tile's output rows, one UNIT-byte store a task
template <int UNIT>
SERL_FN void emit_rows(const Shape& s, uint8_t* dst, const Row* rows, int n_rows,
                       const uint8_t* smem, int tid, int threads) {
  const int units = s.row_bytes / UNIT;
  for (int t = tid; t < n_rows * units; t += threads) {
    const int r = t / units, u = t - r * units;
    Unit<UNIT> v;
    window_unit<UNIT>(smem + r * s.slot, rows[r].window + u * UNIT, v);
    store_unit<UNIT>(dst + rows[r].dst + u * UNIT, v);
  }
}

}  // namespace serl_crop
