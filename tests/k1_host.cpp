// Host (CPU) builds of the control-step kernel's arithmetic, for checks only.
//
// serl_tpu_torch/csrc/control_step.cuh holds the physics of one env's control
// step with no CUDA syntax, so it also compiles as C++ for the CPU. This file
// wraps it in two ways, chosen by a macro at compile time (tests/torch_k1.py
// builds both with g++ and binds them with ctypes):
//
//   default          k1_host_step(): the header's arithmetic over N envs on
//                    the CPU, so that the CPU tests can hold the kernel's
//                    code, not only the plain PyTorch version, against the
//                    JAX package and against control_step_plain;
//   SERL_COUNT_OPS   k1_count_ops(): the same code with every float replaced
//                    by a counting type, which returns the float32 operations
//                    that each env's control step executes.
//
// What k1_count_ops counts: each add, subtract, multiply, divide, square root,
// sine, cosine, tanh and atan2 is one operation (an FMA is two, as in the
// card's published float32 rate); negation, abs, min, max, copysign and
// comparisons are free. An operation with a structural zero operand is not
// counted: a literal 0 of the code (a zero-initialised accumulator, the zero
// entries of a spatial inertia or of a unit vector) or a value derived only
// from such zeros; nor is a multiplication by a literal +-1. A force clamped
// to a literal 0 (an inactive contact) counts as such a zero, so each env
// counts what its own contacts need. Zeros in the state data do count.
#include <math.h>
#include <stdint.h>

#include <cmath>

#ifdef SERL_COUNT_OPS

namespace opcount {

static int64_t g_ops = 0;

// A float32 value with a flag for the structural zeros and units above.
struct Real {
  float v;
  bool zero, unit;
  Real() : v(0.0f), zero(false), unit(false) {}
  Real(float x) : v(x), zero(x == 0.0f), unit(x == 1.0f || x == -1.0f) {}  // a literal
  static Real data(float x) {
    Real r;
    r.v = x;
    return r;
  }
  static Real computed(float x) {
    ++g_ops;
    return data(x);
  }
  explicit operator int() const { return (int)v; }
};

inline Real derived(float x, bool zero) {
  Real r = Real::data(x);
  r.zero = zero;
  return r;
}

inline Real operator-(Real a) {
  Real r = a;
  r.v = -a.v;
  return r;
}
inline Real operator+(Real a, Real b) {
  if (a.zero || b.zero) return derived(a.v + b.v, a.zero && b.zero);
  return Real::computed(a.v + b.v);
}
inline Real operator-(Real a, Real b) {
  if (a.zero || b.zero) return derived(a.v - b.v, a.zero && b.zero);
  return Real::computed(a.v - b.v);
}
inline Real operator*(Real a, Real b) {
  if (a.zero || b.zero) return derived(a.v * b.v, true);
  if (a.unit || b.unit) return derived(a.v * b.v, false);
  return Real::computed(a.v * b.v);
}
inline Real operator/(Real a, Real b) {
  if (a.zero) return derived(a.v / b.v, true);
  return Real::computed(a.v / b.v);
}
inline bool operator<(Real a, Real b) { return a.v < b.v; }
inline bool operator>(Real a, Real b) { return a.v > b.v; }
inline bool operator<=(Real a, Real b) { return a.v <= b.v; }
inline bool operator>=(Real a, Real b) { return a.v >= b.v; }
inline bool operator==(Real a, Real b) { return a.v == b.v; }

inline Real sqrtf(Real a) { return Real::computed(std::sqrt(a.v)); }
inline Real sinf(Real a) { return Real::computed(std::sin(a.v)); }
inline Real cosf(Real a) { return Real::computed(std::cos(a.v)); }
inline Real tanhf(Real a) { return Real::computed(std::tanh(a.v)); }
inline Real atan2f(Real a, Real b) { return Real::computed(std::atan2(a.v, b.v)); }
inline Real fabsf(Real a) { return derived(std::fabs(a.v), a.zero); }
inline Real copysignf(Real a, Real b) { return derived(std::copysign(a.v, b.v), a.zero); }
// min and max keep the flag of the operand they return
inline Real fminf(Real a, Real b) { return std::fmin(a.v, b.v) == a.v ? a : b; }
inline Real fmaxf(Real a, Real b) { return std::fmax(a.v, b.v) == a.v ? a : b; }

}  // namespace opcount

#define float opcount::Real
#include "control_step.cuh"
#undef float

extern "C" {

// ops[e] = float32 operations of env e's control step; `fields` are the 11
// PhysicsState inputs (contiguous float32), `consts` the kernel's constants.
void k1_count_ops(float* const* fields, const float* consts, int n, int64_t* ops) {
  static const int widths[11] = {7, 7, 1, 1, 1, 3, 4, 3, 4, 3, 3};
  opcount::Real C[serl::C_COUNT];
  for (int i = 0; i < serl::C_COUNT; ++i) C[i] = opcount::Real::data(consts[i]);
  for (int e = 0; e < n; ++e) {
    opcount::Real in[11][7], out[11][7];
    for (int f = 0; f < 11; ++f)
      for (int k = 0; k < widths[f]; ++k) in[f][k] = opcount::Real::data(fields[f][widths[f] * e + k]);
    serl::Fields fi = {in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10]};
    serl::Fields fo = {out[0], out[1], out[2], out[3], out[4], out[5],
                       out[6], out[7], out[8], out[9], out[10]};
    opcount::g_ops = 0;
    serl::control_step_env(fi, fo, C, 0);
    ops[e] = opcount::g_ops;
  }
}

}  // extern "C"

#else

#include "control_step.cuh"

extern "C" {

// One control step of n envs on the CPU: 11 input and 11 output PhysicsState
// fields (contiguous float32) and the kernel's constant buffer.
void k1_host_step(float* const* in, float* const* out, const float* consts, int n) {
  const serl::Fields fi = {in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10]};
  const serl::Fields fo = {out[0], out[1], out[2], out[3], out[4], out[5],
                           out[6], out[7], out[8], out[9], out[10]};
  for (int e = 0; e < n; ++e) serl::control_step_env(fi, fo, consts, e);
}

}  // extern "C"

#endif
