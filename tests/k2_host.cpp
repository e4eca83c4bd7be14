// Host (CPU) builds of the render kernel's per-pixel code, for checks only.
//
// serl_tpu_torch/csrc/render.cuh holds one pixel's raycast with no CUDA
// syntax, so it also compiles as C++ for the CPU. This file wraps it in two
// ways, chosen by a macro at compile time (tests/torch_k2.py builds both with
// g++ -ffp-contract=off and binds them with ctypes):
//
//   default          k2_host_render(): the header's code over N envs, both
//                    cameras and every pixel, so that the CPU tests can hold
//                    the kernel's own code against the plain version and the
//                    JAX package;
//   SERL_COUNT_OPS   k2_count_ops(): the same loop with every float
//                    replaced by a counting type, which returns the float32
//                    operations that the render executes.
//
// What k2_count_ops counts: each add, subtract, multiply, divide, square
// root, floor and fmod that the code executes is one operation; negation,
// abs, min, max and comparisons are free. The code has no data-dependent
// loop; only the floor's hit distance (one division, skipped for rays that
// do not point down) depends on the pixel.
#include <stdint.h>

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
inline Real fmodf(Real a, Real b) { return counted(std::fmod(a.v, b.v)); }
inline Real fabsf(Real a) { return Real(std::fabs(a.v)); }
inline Real fminf(Real a, Real b) { return Real(std::fmin(a.v, b.v)); }
inline Real fmaxf(Real a, Real b) { return Real(std::fmax(a.v, b.v)); }

}  // namespace opcount

#define float opcount::Real
#include "render.cuh"
#undef float

extern "C" {

// float32 operations of both cameras of n envs, every pixel, laid out as
// render.cu's serl_render_cameras
int64_t k2_count_ops(const float* scene, const float* grid, const float* consts, int n,
                     int pixels) {
  opcount::Real k[serl_render::K_COUNT];
  for (int i = 0; i < serl_render::K_COUNT; ++i) k[i] = opcount::Real(consts[i]);
  opcount::g_ops = 0;
  for (int e = 0; e < n; ++e) {
    opcount::Real s[serl_render::SCENE_FLOATS];
    for (int i = 0; i < serl_render::SCENE_FLOATS; ++i)
      s[i] = opcount::Real(scene[(int64_t)e * serl_render::SCENE_FLOATS + i]);
    for (int cam = 0; cam < 2; ++cam)
      for (int p = 0; p < pixels; ++p) {
        unsigned char rgb[3];
        serl_render::render_pixel(s, cam, k, opcount::Real(grid[(2 * cam) * pixels + p]),
                                  opcount::Real(grid[(2 * cam + 1) * pixels + p]), rgb);
      }
  }
  return opcount::g_ops;
}

}  // extern "C"

#else

#include "render.cuh"

extern "C" {

// Both cameras of n envs on the CPU, laid out as render.cu's serl_render_cameras.
void k2_host_render(const float* scene, const float* grid, const float* consts,
                    unsigned char* front, unsigned char* wrist, int n, int pixels) {
  for (int e = 0; e < n; ++e)
    for (int cam = 0; cam < 2; ++cam)
      for (int p = 0; p < pixels; ++p)
        serl_render::render_pixel(scene + (int64_t)e * serl_render::SCENE_FLOATS, cam, consts,
                                  grid[(2 * cam) * pixels + p], grid[(2 * cam + 1) * pixels + p],
                                  (cam == 0 ? front : wrist) + ((int64_t)e * pixels + p) * 3);
}

}  // extern "C"

#endif
