// Host (CPU) build of the random-crop kernel's per-thread code, for checks
// only.
//
// serl_tpu_torch/csrc/random_crop.cuh holds K3's four phases as loops over
// tasks that a block's threads share, with no CUDA syntax beyond a few
// primitives, so it also compiles as C++ for the CPU. k3_host_crop() runs
// each block of random_crop.cu's grid in turn: every thread's tasks of a
// phase, then the next phase, as the block's syncs order them, with the
// unit (16-byte, word or byte) that the kernel would take for the same
// pointers. tests/test_torch_crop.py builds it with g++ and holds it against
// the plain gather.
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "random_crop.cuh"

namespace {

constexpr int kThreads = 256;  // random_crop.cu's block

template <int UNIT>
void crop(const serl_crop::Shape& s, const uint8_t* src, uint8_t* dst, const int64_t* offsets) {
  using namespace serl_crop;
  const size_t bytes = ((size_t)s.tile_rows * s.slot + 15) / 16 * 16;
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, bytes));
  Row rows[kMaxTileRows];
  for (int64_t row0 = 0; row0 < s.rows; row0 += s.tile_rows) {
    const int n_rows = (int)(s.rows - row0 < s.tile_rows ? s.rows - row0 : s.tile_rows);
    memset(smem, 0xa5, bytes);  // bytes no phase writes stay visibly wrong
    for (int r = 0; r < n_rows; ++r) row_table(s, offsets, row0, r, rows);
    for (int tid = 0; tid < kThreads; ++tid) stage_rows<UNIT>(s, src, rows, n_rows, smem, tid, kThreads);
    for (int tid = 0; tid < kThreads; ++tid) fill_pads(s, n_rows, smem, tid, kThreads);
    for (int tid = 0; tid < kThreads; ++tid) emit_rows<UNIT>(s, dst, rows, n_rows, smem, tid, kThreads);
  }
  free(smem);
}

}  // namespace

extern "C" {

// One (batch, h, w) image batch of pixel_bytes a pixel, cropped on the CPU;
// returns the unit taken (16, 4 or 1), or -1 for a row too wide for a block.
int k3_host_crop(const uint8_t* src, uint8_t* dst, const int64_t* offsets, int batch, int h,
                 int w, int pixel_bytes, int pad) {
  const serl_crop::Shape s = serl_crop::make_shape(batch, h, w, pixel_bytes, pad);
  if (s.tile_rows <= 0) return -1;
  const int unit = serl_crop::pick_unit(s.row_bytes, &src, &dst, 1);
  if (unit == 16)
    crop<16>(s, src, dst, offsets);
  else if (unit == 4)
    crop<4>(s, src, dst, offsets);
  else
    crop<1>(s, src, dst, offsets);
  return unit;
}

}  // extern "C"
