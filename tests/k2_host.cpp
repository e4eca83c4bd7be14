// Host (CPU) builds of the render kernel's code, for checks only.
//
// serl_tpu_torch/csrc/render.cuh holds K2's three stages (the env's scene
// row by three lanes, the camera's invariants by one task per primitive,
// one pixel) with no CUDA syntax, so it also compiles as C++ for the CPU.
// This file wraps it in two ways, chosen by a macro at compile time
// (tests/torch_k2.py builds both with g++ -ffp-contract=off and binds them
// with ctypes):
//
//   default          k2_host_scene(): the scene rows of N envs from their
//                    physics state, the joint tasks, then lanes 0, 1, 2 in
//                    turn, as render.cu's first steps compute them; k2_host_render(): both
//                    cameras' frames of N envs from given scene rows (the
//                    plain version's, so that the CPU tests can hold the
//                    kernel's per-camera and per-pixel code against it bit
//                    for bit); k2_parity_mismatches(): the pixel code's
//                    checker parity against fmodf over integer-valued floats;
//   SERL_COUNT_OPS   k2_count_ops(): the same stages with every float
//                    replaced by a counting type, which returns the float32
//                    operations of the scene rows, of the camera invariants
//                    and of the pixels.
//
// What k2_count_ops counts: each add, subtract, multiply, divide,
// reciprocal, square root, floor, sine and cosine that the code executes is
// one operation; negation, abs, min, max and comparisons are free. The code
// has no data-dependent loop; only the floor's hit distance (one division,
// skipped for rays that do not point down) depends on the pixel.
#include <stdint.h>
#include <string.h>

#include <cmath>

#ifdef SERL_COUNT_OPS

namespace opcount {

static int64_t g_ops = 0;

struct Real {
  float v;
  Real() : v(0.0f) {}
  Real(float x) : v(x) {}
  explicit operator int() const { return (int)v; }
};

inline Real counted(float x) {
  ++g_ops;
  return Real(x);
}
inline Real operator-(Real a) { return Real(-a.v); }
inline Real operator+(Real a, Real b) { return counted(a.v + b.v); }
inline Real operator-(Real a, Real b) { return counted(a.v - b.v); }
inline Real operator*(Real a, Real b) { return counted(a.v * b.v); }
inline Real operator/(Real a, Real b) { return counted(a.v / b.v); }
inline bool operator<(Real a, Real b) { return a.v < b.v; }
inline bool operator>(Real a, Real b) { return a.v > b.v; }
inline bool operator<=(Real a, Real b) { return a.v <= b.v; }
inline bool operator>=(Real a, Real b) { return a.v >= b.v; }
inline bool operator==(Real a, Real b) { return a.v == b.v; }
inline Real sqrtf(Real a) { return counted(std::sqrt(a.v)); }
inline Real floorf(Real a) { return counted(std::floor(a.v)); }
inline Real sinf(Real a) { return counted(std::sin(a.v)); }
inline Real cosf(Real a) { return counted(std::cos(a.v)); }
inline Real fabsf(Real a) { return Real(std::fabs(a.v)); }
inline Real fminf(Real a, Real b) { return Real(std::fmin(a.v, b.v)); }
inline Real fmaxf(Real a, Real b) { return Real(std::fmax(a.v, b.v)); }

}  // namespace opcount

#define float opcount::Real
#include "render.cuh"
#undef float

using opcount::Real;

extern "C" {

// float32 operations of n envs' scene rows (out[0]), of both cameras'
// invariants (out[1]) and of both cameras' pixels (out[2]), with the
// state, constant row and grid laid out as render.cu's serl_render_cameras
void k2_count_ops(const float* qpos, const float* theta, const float* cube_pos,
                  const float* cube_quat, const float* consts, const float* grid, int n,
                  int pixels, int64_t* out) {
  using namespace serl_render;
  Real C[C_COUNT];
  for (int i = 0; i < C_COUNT; ++i) C[i] = Real(consts[i]);
  out[0] = out[1] = out[2] = 0;
  for (int e = 0; e < n; ++e) {
    Real q[7], cp[3], cq[4];
    for (int i = 0; i < 7; ++i) q[i] = Real(qpos[7 * e + i]);
    for (int i = 0; i < 3; ++i) cp[i] = Real(cube_pos[3 * e + i]);
    for (int i = 0; i < 4; ++i) cq[i] = Real(cube_quat[4 * e + i]);
    Real scene[SCENE_FLOATS], trig[14];
    opcount::g_ops = 0;
    for (int k = 0; k < 7; ++k) joint_trig(k, q, trig);
    for (int lane = 0; lane < 3; ++lane) scene_lane(lane, trig, Real(theta[e]), cp, cq, C, scene);
    out[0] += opcount::g_ops;
    for (int cam = 0; cam < 2; ++cam) {
      Real inv[INV_FLOATS];
      opcount::g_ops = 0;
      for (int task = 0; task < INV_TASKS; ++task) camera_invariants(task, scene, cam, inv);
      out[1] += opcount::g_ops;
      opcount::g_ops = 0;
      for (int p = 0; p < pixels; ++p) {
        unsigned char rgb[3];
        render_pixel(scene, inv, cam, C + C_RENDER, Real(grid[(2 * cam) * pixels + p]),
                     Real(grid[(2 * cam + 1) * pixels + p]), rgb);
      }
      out[2] += opcount::g_ops;
    }
  }
}

}  // extern "C"

#else

#include "render.cuh"

extern "C" {

// The scene rows (n, SCENE_FLOATS) of n envs from their state
void k2_host_scene(const float* qpos, const float* theta, const float* cube_pos,
                   const float* cube_quat, const float* consts, int n, float* scene) {
  for (int e = 0; e < n; ++e) {
    float trig[14];
    for (int k = 0; k < 7; ++k) serl_render::joint_trig(k, qpos + 7 * e, trig);
    for (int lane = 0; lane < 3; ++lane)
      serl_render::scene_lane(lane, trig, theta[e], cube_pos + 3 * e, cube_quat + 4 * e, consts,
                              scene + (int64_t)e * serl_render::SCENE_FLOATS);
  }
}

// Both cameras of n envs from their scene rows, laid out as render.cu's outputs
void k2_host_render(const float* scene, const float* grid, const float* consts,
                    unsigned char* front, unsigned char* wrist, int n, int pixels) {
  using namespace serl_render;
  for (int e = 0; e < n; ++e)
    for (int cam = 0; cam < 2; ++cam) {
      const float* row = scene + (int64_t)e * SCENE_FLOATS;
      float inv[INV_FLOATS];
      for (int task = 0; task < INV_TASKS; ++task) camera_invariants(task, row, cam, inv);
      for (int p = 0; p < pixels; ++p)
        render_pixel(row, inv, cam, consts + C_RENDER, grid[(2 * cam) * pixels + p],
                     grid[(2 * cam + 1) * pixels + p],
                     (cam == 0 ? front : wrist) + ((int64_t)e * pixels + p) * 3);
    }
}

// Integer-valued floats k where even(k) differs from fmodf(k, 2) == 0:
// every integer of magnitude up to 2^24 + 4 and +-0, against fmodf; every
// float from 2^24 to 2^32 of either sign, which are all even integers (their
// ulp is 2 or more, so fmodf gives 0), against true. The floor's k stays
// below 2^32: |p| <= 1e9 m at the miss distance t = 1e9, over 0.75 m squares.
int64_t k2_parity_mismatches() {
  int64_t bad = 0;
  for (int32_t i = -(1 << 24) - 4; i <= (1 << 24) + 4; ++i)
    bad += serl_render::even((float)i) != (fmodf((float)i, 2.0f) == 0.0f);
  bad += !serl_render::even(0.0f) + !serl_render::even(-0.0f);
  uint32_t lo, hi;
  const float from = 16777216.0f, to = 4294967296.0f;  // 2^24, 2^32
  memcpy(&lo, &from, 4);
  memcpy(&hi, &to, 4);
  for (uint32_t bits = lo; bits <= hi; ++bits) {
    float k;
    memcpy(&k, &bits, 4);
    bad += !serl_render::even(k) + !serl_render::even(-k);
  }
  return bad;
}

}  // extern "C"

#endif
