// CUDA kernels for K5: y = tanh(LayerNorm(x W + b) * gamma + beta) over the
// last axis, the Dense fused in, and its backward.
//
// Replaces: the Dense -> LayerNorm -> tanh triple of
// serl_tpu/networks/mlp.py::EnsembleMLP (:115-122; MLP :41-47),
// serl_tpu/vision/encoders.py:135-137 (the bottleneck) and
// serl_tpu/vision/encoding.py:98-103 (the proprio Dense), which XLA fuses on
// the TPU. LayerNorm's epsilon is the caller's (flax's 1e-6) and one (D,)
// gamma, beta serve every ensemble member, as the JAX ensemble shares one
// LayerNorm.
//
// Three input forms, all read in place: x (M, K) through one weight, either
// nn.Linear's (D, K) (layout DK) or a (K, D) kernel (layout KD); x (M, K)
// shared by the E members of an (E, K, D) kernel (x member stride 0); and
// x (E, M, K) per member. Output y (E, M, D), E = 1 for one weight.
//
// Forward. One block of 8 warps owns 32 rows (16 where 32-row blocks would
// leave SMs idle) of one member and all D columns, so a row's LayerNorm
// statistics finish inside the block: warp w computes the rows x D/8 tile at
// columns w*D/8 with mma.sync m16n8k8 TF32 on
// the tensor cores, at fp32 accuracy by the 3xTF32 split (a = big + small,
// the accumulator takes small*big + big*small + big*big in fp32, each term
// run over all of the warp's tiles before the next). x and W
// move through shared memory in K-chunks of 32, double-buffered with
// cp.async (16-byte copies where rows and pointers allow, else 4-byte ones;
// the ragged tail is zero-filled), with padded pitches so that the fragment
// reads are free of bank conflicts. The epilogue runs in registers: bias,
// row sums by quad shuffles and then across the 8 warps through shared
// memory, the two-pass variance, gamma and beta, tanh as
// sign(z) (1 - e) / (1 + e) with e = expf(-2|z|). The pre-activation h and
// the row mean and rstd are stored only when autograd needs them.
//
// Split K. Where the row blocks fill less than the card (few rows, or a
// deep K such as the ResNet heads' 4,096), each 16-row tile is cut into S
// blocks along K (gridDim.z = S), each walking its own slice of the chunks.
// A block writes its accumulators to scratch in its threads' fragment
// order, takes a ticket from an int32 counter for its tile, and the last of
// the S adds the S partials in slice order (a fixed order: the result
// repeats bit for bit) and runs the epilogue; it resets the counter. S is
// the most that keeps every slice at least kMinSliceChunks chunks long,
// the blocks within one wave of the SMs and S <= kMaxSplits (the last
// block reads S partials of 16 x D floats alone).
//
// Backward. One block of 8 warps owns 32 rows of one member, a warp a row at
// a time, a lane every 32nd column. With g = dy (1 - y^2) and
// x_hat = (h - mean) rstd it writes
//   dh = rstd (g gamma - mean(g gamma) - x_hat mean(g gamma x_hat)).
// With weight grads it also gives, in the same launch, dgamma = sum g x_hat
// and dbeta = sum g over every member's rows, and the Dense's dbias per
// member, sum dh over the member's rows. These sums repeat bit for bit: each
// block writes its column partials to scratch and takes a ticket from an
// int32 counter; where a member has more than 16 blocks, the last block of
// each group of 16 adds the group's partials in block order; the last of a
// member adds its blocks (or groups) in order (dbias), and the last member
// adds the members in order (dgamma, dbeta). Each last arrival resets its
// counter. No value goes through an atomic.
//
// What bounds it on an H100: bytes at the main path's shapes. The critic's
// (E, M, K, D) = (10, 256, 256, 256) forward moves x, W, y and (with
// autograd) h, 10.5 MB, 3.1 us at 3.35 TB/s; its 336 MFLOP, tripled by
// 3xTF32, take 2.0 us at the tensor cores' 495 TFLOP/s (plain fp32 FFMA
// would take 5.0 us at 67 TFLOP/s and make it bound by operations). At
// (1, 256, 4096, 256), the ResNet heads' bottleneck, the 3xTF32 product
// (1.6 GFLOP, 3.3 us) bounds it, but without split K its 16 blocks would
// each walk 128 chunks on 16 of the 132 SMs. The
// backward reads dy, y, h and writes dh: 16 bytes and ~16 fp32 operations an
// element. At these sizes a launch costs as much as the work, so each
// direction is one launch, reads each input once and keeps a row in
// registers.
//
// C ABI (bound with ctypes): serl_dense_ln_tanh_forward and
// serl_dense_ln_tanh_backward take device pointers, strides in floats, the
// sizes and the CUDA stream, and return cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for arguments the kernels do not take).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 8;      // each all of the block's rows x D / 8 columns
constexpr int kChunk = 32;        // K per pipeline stage
constexpr int kStages = 2;        // K-chunks in shared memory, kStages - 1 in flight
constexpr int kXPitch = kChunk + 4;  // x tile: [row][k], row pitch in floats
constexpr int kBwdRows = 32;      // rows of one member per backward block
constexpr int kBwdWarps = 8;
constexpr int kRowsPerWarp = kBwdRows / kBwdWarps;
constexpr int kGroup = 16;        // backward blocks per first-level partial sum
constexpr int kMinSliceChunks = 2;  // split K: chunks per block at least
constexpr int kMaxSplits = 16;      // split K: blocks per 16-row tile at most
constexpr int kMaxDevices = 64;

// ROWS rows of one member per forward block: 32, or 16 where 32-row blocks
// would leave SMs idle
template <int D, bool KD, int ROWS>
struct FwdTile {
  // W tile: KD [k][D + 8] (column reads by k row), DK [d][kChunk + 4]
  static constexpr int kWStage = KD ? kChunk * (D + 8) : D * (kChunk + 4);
  static constexpr int kXStage = ROWS * kXPitch;
  static constexpr int kSmemBytes = kStages * (kWStage + kXStage) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = big + small, both TF32 (10 mantissa bits, the low 13 bits zero), each
// rounded to nearest, ties away from zero; v - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(v - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// c += a b for one m16n8k8 TF32 tile, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FwdArgs {
  const float* x;
  int64_t x_member_stride, x_row_stride;
  const float* w;
  int64_t w_member_stride;
  const float* bias;
  int64_t bias_member_stride;
  const float* gamma;
  const float* beta;
  float* y;
  float* h;  // null: h, mean and rstd are not stored
  float* mean;
  float* rstd;
  float* partial;  // split K: [tile][split][ROWS * D] accumulators
  int* counters;   // split K: a ticket per tile, zero between launches
  int rows, k;
  float eps;
  bool x_vec, w_vec;  // 16-byte copies allowed
};

// True in the block that arrives last of `expected` at `counter`, which it
// resets; the partials written before the call are visible to it.
__device__ __forceinline__ bool arrive_last(int* counter, int expected) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Stage one K-chunk of the block's x rows and of W into shared memory.
template <int D, bool KD, int ROWS>
__device__ __forceinline__ void load_chunk(const FwdArgs& a, const float* x, const float* w,
                                           int row0, int k0, float* xs, float* ws) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ROWS * (kChunk / 4); i += kFwdWarps * 32) {
    const int r = i / (kChunk / 4), c = (i % (kChunk / 4)) * 4;
    const int row = row0 + r, k = k0 + c;
    float* dst = xs + r * kXPitch + c;
    const float* src = x + (int64_t)row * a.x_row_stride + k;
    if (a.x_vec) {
      if (row < a.rows && k < a.k) cp_async16(dst, src);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (row < a.rows && k + j < a.k) cp_async4(dst + j, src + j);
        else dst[j] = 0.f;
      }
    }
  }
  if constexpr (KD) {  // W[k][d] at w + k * D + d
    for (int i = tid; i < kChunk * (D / 4); i += kFwdWarps * 32) {
      const int kk = i / (D / 4), d = (i % (D / 4)) * 4;
      const int k = k0 + kk;
      float* dst = ws + kk * (D + 8) + d;
      const float* src = w + (int64_t)k * D + d;
      if (k >= a.k) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (a.w_vec) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(dst + j, src + j);
      }
    }
  } else {  // W[k][d] at w + d * K + k (nn.Linear's weight)
    for (int i = tid; i < D * (kChunk / 4); i += kFwdWarps * 32) {
      const int d = i / (kChunk / 4), c = (i % (kChunk / 4)) * 4;
      const int k = k0 + c;
      float* dst = ws + d * (kChunk + 4) + c;
      const float* src = w + (int64_t)d * a.k + k;
      if (a.w_vec) {
        if (k < a.k) cp_async16(dst, src);
        else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k + j < a.k) cp_async4(dst + j, src + j);
          else dst[j] = 0.f;
        }
      }
    }
  }
}

template <int D, bool KD, int ROWS>
__global__ void __launch_bounds__(kFwdWarps * 32)
    dense_ln_tanh_fwd_kernel(const FwdArgs a) {
  constexpr int kMT = ROWS / 16;        // m-tiles of 16 rows
  constexpr int kCols = D / kFwdWarps;  // columns per warp
  constexpr int kNT = kCols / 8;        // n-tiles of 8 per warp
  static_assert(kNT >= 1, "D must be a multiple of 8 * kFwdWarps");
  extern __shared__ __align__(16) float smem[];
  using Tile = FwdTile<D, KD, ROWS>;
  float* xs0 = smem;
  float* ws0 = smem + kStages * Tile::kXStage;
  __shared__ float red[2][kFwdWarps][ROWS];

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = warp * kCols;
  const float* x = a.x + e * a.x_member_stride;
  const float* w = a.w + e * a.w_member_stride;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // this block's slice of the K-chunks (all of them unless K is split):
  // kStages - 1 chunks in flight, one commit group per chunk (empty past
  // the last), the slice's chunk c in stage c % kStages
  const int all_chunks = (a.k + kChunk - 1) / kChunk;
  const int split = blockIdx.z, splits = gridDim.z;
  const int first = (int)((int64_t)all_chunks * split / splits);
  const int chunks = (int)((int64_t)all_chunks * (split + 1) / splits) - first;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      load_chunk<D, KD, ROWS>(a, x, w, row0, (first + c) * kChunk, xs0 + c * Tile::kXStage,
                        ws0 + c * Tile::kWStage);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1 is consumed
    const int next = c + kStages - 1;
    if (next < chunks)
      load_chunk<D, KD, ROWS>(a, x, w, row0, (first + next) * kChunk,
                        xs0 + (next % kStages) * Tile::kXStage,
                        ws0 + (next % kStages) * Tile::kWStage);
    cp_async_commit();
    const float* xs = xs0 + (c % kStages) * Tile::kXStage;
    const float* ws = ws0 + (c % kStages) * Tile::kWStage;
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 8) {
      uint32_t a_big[kMT][4], a_small[kMT][4], b_big[kNT][2], b_small[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* xa = xs + (mt * 16 + g) * kXPitch + ks + t;
        split_tf32(xa[0], a_big[mt][0], a_small[mt][0]);                // (g, t)
        split_tf32(xa[8 * kXPitch], a_big[mt][1], a_small[mt][1]);      // (g + 8, t)
        split_tf32(xa[4], a_big[mt][2], a_small[mt][2]);                // (g, t + 4)
        split_tf32(xa[8 * kXPitch + 4], a_big[mt][3], a_small[mt][3]);  // (g + 8, t + 4)
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = n0 + nt * 8 + g;  // (k = t, n) and (k = t + 4, n)
        if constexpr (KD) {
          split_tf32(ws[(ks + t) * (D + 8) + n], b_big[nt][0], b_small[nt][0]);
          split_tf32(ws[(ks + t + 4) * (D + 8) + n], b_big[nt][1], b_small[nt][1]);
        } else {
          split_tf32(ws[n * (kChunk + 4) + ks + t], b_big[nt][0], b_small[nt][0]);
          split_tf32(ws[n * (kChunk + 4) + ks + t + 4], b_big[nt][1], b_small[nt][1]);
        }
      }
      // the three products in three passes over the tiles, so that kMT * kNT
      // independent products stand between two into the same accumulator
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[mt][nt], a_small[mt], b_big[nt][0], b_big[nt][1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[mt][nt], a_big[mt], b_small[nt][0], b_small[nt][1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(acc[mt][nt], a_big[mt], b_big[nt][0], b_big[nt][1]);
    }
  }
  cp_async_wait<0>();

  if (splits > 1) {  // split K: the last block of the tile adds the slices in order
    constexpr int kThreads = kFwdWarps * 32, kAcc = kMT * kNT * 4;  // kThreads * kAcc = ROWS * D
    const int64_t tile = (int64_t)e * gridDim.x + blockIdx.x;
    float* mine = a.partial + (tile * splits + split) * kAcc * kThreads + threadIdx.x;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          __stcg(mine + ((mt * kNT + nt) * 4 + q) * kThreads, acc[mt][nt][q]);
    if (!arrive_last(a.counters + tile, splits)) return;
    const float* slices = a.partial + tile * splits * kAcc * kThreads + threadIdx.x;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* slice = slices + (int64_t)s * kAcc * kThreads;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][nt][q] += __ldcg(slice + ((mt * kNT + nt) * 4 + q) * kThreads);
    }
  }

  // epilogue: acc[mt][nt][2 * half + j] is row mt * 16 + g + 8 * half,
  // column n0 + nt * 8 + 2 * t + j
  const float* bias = a.bias + e * a.bias_member_stride;
  float gam[kNT][2], bet[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + nt * 8 + 2 * t + j;
      gam[nt][j] = a.gamma[col];
      bet[nt][j] = a.beta[col];
      const float b = bias[col];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][nt][j] += b;
        acc[mt][nt][2 + j] += b;
      }
    }

  float mean[kMT][2], rstd[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s += acc[mt][nt][2 * half] + acc[mt][nt][2 * half + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) red[0][warp][mt * 16 + g + 8 * half] = s;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kFwdWarps; ++q) s += red[0][q][r];
      const float m = s / D;
      mean[mt][half] = m;
      float v = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float d0 = acc[mt][nt][2 * half] - m, d1 = acc[mt][nt][2 * half + 1] - m;
        v += d0 * d0 + d1 * d1;
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[1][warp][r] = v;
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kFwdWarps; ++q) v += red[1][q][r];
      rstd[mt][half] = 1.0f / sqrtf(v / D + a.eps);
    }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      const int row = row0 + r;
      if (row >= a.rows) continue;
      const int64_t base = ((int64_t)e * a.rows + row) * D;
      const float m = mean[mt][half], rs = rstd[mt][half];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        float out[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z = (acc[mt][nt][2 * half + j] - m) * rs * gam[nt][j] + bet[nt][j];
          const float ez = expf(-2.0f * fabsf(z));
          const float th = (1.0f - ez) / (1.0f + ez);
          out[j] = z < 0.f ? -th : th;
        }
        *reinterpret_cast<float2*>(a.y + base + col) = make_float2(out[0], out[1]);
        if (a.h != nullptr)
          *reinterpret_cast<float2*>(a.h + base + col) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
      if (a.h != nullptr && warp == 0 && t == 0) {
        a.mean[(int64_t)e * a.rows + row] = m;
        a.rstd[(int64_t)e * a.rows + row] = rs;
      }
    }
}

struct BwdArgs {
  const float* dy;
  const float* y;
  const float* h;
  const float* mean;
  const float* rstd;
  const float* gamma;
  float* dh;
  int members, rows;
  // weight grads (all null without them)
  float* partial;         // [members][tiles][3 D]: sum g x_hat | sum g | sum dh
  float* group_partial;   // [members][groups][3 D]
  float* member_partial;  // [members][2 D]
  float* dgamma;
  float* dbeta;
  float* dbias;  // [members][D]
  int* counters;  // 1 + members + members * groups, zero between launches
};

// store(i, sum over s < n of src[s * width + i]) for i < width, the sum taken
// in order of s, by the whole block
template <class Store>
__device__ __forceinline__ void sum_slices(const float* src, int n, int width, Store store) {
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float v = 0.f;
    int s = 0;
    for (; s + 8 <= n; s += 8) {
      float part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u] = __ldcg(src + (int64_t)(s + u) * width + i);
#pragma unroll
      for (int u = 0; u < 8; ++u) v += part[u];
    }
    for (; s < n; ++s) v += __ldcg(src + (int64_t)s * width + i);
    store(i, v);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32) dense_ln_tanh_bwd_kernel(const BwdArgs a) {
  constexpr int kNV = D / 32;  // columns per lane: lane + 32 j
  __shared__ float part[kBwdWarps][3 * D];
  const int e = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = tile * kBwdRows + warp * kRowsPerWarp;

  float gam[kNV];
#pragma unroll
  for (int j = 0; j < kNV; ++j) gam[j] = a.gamma[lane + 32 * j];

  // every load of the warp's rows first, zeros past the last row
  float dy[kRowsPerWarp][kNV], yv[kRowsPerWarp][kNV], hv[kRowsPerWarp][kNV];
  float m[kRowsPerWarp], rs[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + i;
    const bool in = row < a.rows;
    const int64_t r = (int64_t)e * a.rows + row;
    m[i] = in ? a.mean[r] : 0.f;
    rs[i] = in ? a.rstd[r] : 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const int64_t o = r * D + lane + 32 * j;
      dy[i][j] = in ? a.dy[o] : 0.f;
      yv[i][j] = in ? a.y[o] : 0.f;
      hv[i][j] = in ? a.h[o] : 0.f;
    }
  }

  float sum_gx[kNV], sum_g[kNV], sum_dh[kNV];
#pragma unroll
  for (int j = 0; j < kNV; ++j) sum_gx[j] = sum_g[j] = sum_dh[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float gg[kNV], xh[kNV], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      gg[j] = dy[i][j] * (1.0f - yv[i][j] * yv[i][j]);
      xh[j] = (hv[i][j] - m[i]) * rs[i];
      const float gw = gg[j] * gam[j];
      s1 += gw;
      s2 += gw * xh[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float c1 = s1 / D, c2 = s2 / D;
    const int row = row0 + i;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const float d = rs[i] * (gg[j] * gam[j] - c1 - xh[j] * c2);
      if (row < a.rows) a.dh[((int64_t)e * a.rows + row) * D + lane + 32 * j] = d;
      sum_gx[j] += gg[j] * xh[j];
      sum_g[j] += gg[j];
      sum_dh[j] += d;
    }
  }
  if (a.partial == nullptr) return;

  // the block's column partials, warps added in order
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    part[warp][lane + 32 * j] = sum_gx[j];
    part[warp][D + lane + 32 * j] = sum_g[j];
    part[warp][2 * D + lane + 32 * j] = sum_dh[j];
  }
  __syncthreads();
  float* slot = a.partial + ((int64_t)e * tiles + tile) * 3 * D;
  for (int i = threadIdx.x; i < 3 * D; i += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdWarps; ++q) v += part[q][i];
    slot[i] = v;
  }

  // a member's tiles, in groups of kGroup when it has more (each level
  // costs a fence, a ticket and a round of loads, so none is taken that
  // one block could skip)
  const int groups = (tiles + kGroup - 1) / kGroup;
  const float* member_src = a.partial + (int64_t)e * tiles * 3 * D;
  int member_n = tiles;
  if (groups > 1) {
    const int group = tile / kGroup, in_group = min(kGroup, tiles - group * kGroup);
    if (!arrive_last(a.counters + 1 + a.members + e * groups + group, in_group)) return;
    float* gslot = a.group_partial + ((int64_t)e * groups + group) * 3 * D;
    sum_slices(a.partial + ((int64_t)e * tiles + group * kGroup) * 3 * D, in_group, 3 * D,
               [&](int i, float v) { gslot[i] = v; });
    member_src = a.group_partial + (int64_t)e * groups * 3 * D;
    member_n = groups;
  }
  if (!arrive_last(a.counters + 1 + e, member_n)) return;
  float* dbias = a.dbias + (int64_t)e * D;
  if (a.members == 1) {
    sum_slices(member_src, member_n, 3 * D, [&](int i, float v) {
      if (i < D) a.dgamma[i] = v;
      else if (i < 2 * D) a.dbeta[i - D] = v;
      else dbias[i - 2 * D] = v;
    });
    return;
  }
  float* mslot = a.member_partial + (int64_t)e * 2 * D;
  sum_slices(member_src, member_n, 3 * D, [&](int i, float v) {
    if (i < 2 * D) mslot[i] = v;
    else dbias[i - 2 * D] = v;
  });

  // the members, in order
  if (!arrive_last(a.counters, a.members)) return;
  sum_slices(a.member_partial, a.members, 2 * D, [&](int i, float v) {
    if (i < D) a.dgamma[i] = v;
    else a.dbeta[i - D] = v;
  });
}

template <int D, bool KD, int ROWS>
int launch_forward(const FwdArgs& a, int members, int splits, int device, cudaStream_t stream) {
  static bool attribute_set[kMaxDevices] = {};
  constexpr int smem = FwdTile<D, KD, ROWS>::kSmemBytes;
  if (!attribute_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_ln_tanh_fwd_kernel<D, KD, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set[device] = true;
  }
  const dim3 grid((unsigned)((a.rows + ROWS - 1) / ROWS), (unsigned)members, (unsigned)splits);
  dense_ln_tanh_fwd_kernel<D, KD, ROWS><<<grid, kFwdWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// 32-row blocks where they fill every SM, else 16-row ones, and those split
// along K where they too leave SMs idle (and scratch and tickets allow). A
// block's time is set by its mma.sync rate and its W traffic from L2, both
// per SM, and not by the depth of the copy pipeline: spreading a call over
// more SMs helps where 32-row blocks leave SMs idle, and costs W traffic
// where they fill the card several times over.
template <bool KD>
int forward_for_layout(const FwdArgs& a, int members, int d, long long n_partial,
                       int n_counters, cudaStream_t stream) {
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const bool wide = (int64_t)members * ((a.rows + 31) / 32) >= sms[device];
  int splits = 1;
  if (!wide && a.partial != nullptr) {
    const int64_t tiles = (int64_t)members * ((a.rows + 15) / 16);
    const int chunks = (a.k + kChunk - 1) / kChunk;
    int64_t s = sms[device] / tiles;
    if (s > chunks / kMinSliceChunks) s = chunks / kMinSliceChunks;
    if (s > kMaxSplits) s = kMaxSplits;
    if (s > 1 && tiles <= n_counters && tiles * s * 16 * d <= n_partial) splits = (int)s;
  }
  switch (d * 2 + wide) {
    case 128: return launch_forward<64, KD, 16>(a, members, splits, device, stream);
    case 129: return launch_forward<64, KD, 32>(a, members, 1, device, stream);
    case 256: return launch_forward<128, KD, 16>(a, members, splits, device, stream);
    case 257: return launch_forward<128, KD, 32>(a, members, 1, device, stream);
    case 512: return launch_forward<256, KD, 16>(a, members, splits, device, stream);
    case 513: return launch_forward<256, KD, 32>(a, members, 1, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_backward(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.rows + kBwdRows - 1) / kBwdRows), (unsigned)a.members);
  dense_ln_tanh_bwd_kernel<D><<<grid, kBwdWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

// {backward rows per block, backward blocks per group}
void serl_dense_ln_tanh_config(int* out) {
  out[0] = kBwdRows;
  out[1] = kGroup;
}

const char* serl_dense_ln_tanh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: rows of K floats at x + e * x_member_stride + row * x_row_stride
// (x_member_stride 0: shared by the members); w: member e at
// w + e * w_member_stride, (K, D) row-major if w_layout_kd else (D, K)
// row-major; bias: D floats at bias + e * bias_member_stride; y (and h if
// not null): (members, rows, D); mean, rstd: (members, rows). partial
// (n_partial floats) and counters (n_counters ints, all zero: each launch
// leaves them so) let the kernel split K; with partial null it does not.
int serl_dense_ln_tanh_forward(const float* x, long long x_member_stride, long long x_row_stride,
                               const float* w, long long w_member_stride, int w_layout_kd,
                               const float* bias, long long bias_member_stride,
                               const float* gamma, const float* beta, float* y, float* h,
                               float* mean, float* rstd, int members, int rows, int k, int d,
                               float eps, float* partial, long long n_partial, int* counters,
                               int n_counters, void* stream) {
  if (members <= 0 || members > 65535 || rows < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (h != nullptr && (mean == nullptr || rstd == nullptr)) return (int)cudaErrorInvalidValue;
  if (partial != nullptr && counters == nullptr) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  FwdArgs a;
  a.x = x;
  a.x_member_stride = x_member_stride;
  a.x_row_stride = x_row_stride;
  a.w = w;
  a.w_member_stride = w_member_stride;
  a.bias = bias;
  a.bias_member_stride = bias_member_stride;
  a.gamma = gamma;
  a.beta = beta;
  a.y = y;
  a.h = h;
  a.mean = mean;
  a.rstd = rstd;
  a.partial = partial;
  a.counters = counters;
  a.rows = rows;
  a.k = k;
  a.eps = eps;
  a.x_vec = aligned16(x) && k % 4 == 0 && x_row_stride % 4 == 0 && x_member_stride % 4 == 0;
  a.w_vec = aligned16(w) && (w_layout_kd ? d % 4 == 0 : k % 4 == 0) && w_member_stride % 4 == 0;
  if (!aligned16(y) || (h != nullptr && !aligned16(h))) return (int)cudaErrorInvalidValue;
  return w_layout_kd ? forward_for_layout<true>(a, members, d, n_partial, n_counters,
                                                (cudaStream_t)stream)
                     : forward_for_layout<false>(a, members, d, n_partial, n_counters,
                                                 (cudaStream_t)stream);
}

// dy, y, h, dh: (members, rows, D); mean, rstd: (members, rows). With
// scratch not null also dgamma, dbeta (D), dbias (members, D); scratch holds
// members * (tiles + groups) * 3 D + members * 2 D floats and counters
// 1 + members + members * groups ints, all zero (each launch leaves them so).
int serl_dense_ln_tanh_backward(const float* dy, const float* y, const float* h,
                                const float* mean, const float* rstd, const float* gamma,
                                float* dh, int members, int rows, int d, float* scratch,
                                float* dgamma, float* dbeta, float* dbias, int* counters,
                                int n_counters, void* stream) {
  if (members <= 0 || members > 65535 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int tiles = (rows + kBwdRows - 1) / kBwdRows;
  const int groups = (tiles + kGroup - 1) / kGroup;
  BwdArgs a = {};
  a.dy = dy;
  a.y = y;
  a.h = h;
  a.mean = mean;
  a.rstd = rstd;
  a.gamma = gamma;
  a.dh = dh;
  a.members = members;
  a.rows = rows;
  if (scratch != nullptr) {
    if (counters == nullptr || (long long)1 + members + (long long)members * groups > n_counters)
      return (int)cudaErrorInvalidValue;
    a.partial = scratch;
    a.group_partial = scratch + (int64_t)members * tiles * 3 * d;
    a.member_partial = a.group_partial + (int64_t)members * groups * 3 * d;
    a.dgamma = dgamma;
    a.dbeta = dbeta;
    a.dbias = dbias;
    a.counters = counters;
  }
  switch (d) {
    case 64: return launch_backward<64>(a, (cudaStream_t)stream);
    case 128: return launch_backward<128>(a, (cudaStream_t)stream);
    case 256: return launch_backward<256>(a, (cudaStream_t)stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
