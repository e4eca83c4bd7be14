// Host (CPU) builds of the control-step kernel's arithmetic, for checks only.
//
// serl_tpu_torch/csrc/control_step.cuh holds the physics of one env's control
// step as phases of a lane group, with no CUDA syntax outside `phase`, so it
// also compiles as C++ for the CPU: there `phase` runs the lanes one after
// another and the group sync is a no-op. This file wraps it in two ways,
// chosen by a macro at compile time (tests/torch_k1.py builds both with g++
// and binds them with ctypes):
//
//   default          k1_host_step(): the header's arithmetic over N envs (and
//                    an obstacle table) on
//                    the CPU, so that the CPU tests can hold the kernel's
//                    code, not only the plain PyTorch version, against the
//                    JAX package and against control_step_plain;
//                    k1_div_mismatches() holds the header's division by a
//                    reciprocal to x / d on random pairs;
//   SERL_COUNT_OPS   k1_count_ops(): the same code with every float replaced
//                    by a counting type, which returns the float32 operations
//                    that each env's control step executes, and its critical
//                    path: per phase the most operations that any one lane
//                    executes, summed over the phases and substeps.
//
// What k1_count_ops counts: each add, subtract, multiply, divide, square root,
// sine, cosine, tanh and atan2 is one operation (an FMA is two, as in the
// card's published float32 rate); negation, abs, min, max, copysign and
// comparisons are free. An operation with a structural zero operand is not
// counted: a literal 0 of the code (a zero-initialised accumulator, the zero
// entries of a spatial inertia or of a unit vector) or a value derived only
// from such zeros; nor is a multiplication by a literal +-1. A force clamped
// to a literal 0 (an inactive contact) counts as such a zero, so each env
// counts what its own contacts need. Zeros in the state data do count. A
// value that several lanes compute alike (the header's `Repeat`) counts once
// in the total and on every lane that computes it in the critical path.
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <cstring>
#include <random>

#ifdef SERL_COUNT_OPS

namespace opcount {

static int64_t g_ops = 0;        // the env's operations, each value once
static int64_t g_lane_ops = 0;   // the current lane's operations in this phase
static int64_t g_phase_max = 0;  // the most of any lane so far in this phase
static int64_t g_path = 0;       // the critical path
static bool g_repeat = false;    // inside a Repeat scope

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
    if (!g_repeat) ++g_ops;
    ++g_lane_ops;
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

#define SERL_COUNT_HOOKS
#define SERL_LANE_BEGIN() (opcount::g_lane_ops = 0)
#define SERL_LANE_END() (opcount::g_phase_max = std::max(opcount::g_phase_max, opcount::g_lane_ops))
#define SERL_PHASE_END() (opcount::g_path += opcount::g_phase_max, opcount::g_phase_max = 0)

namespace serl {
struct Repeat {
  bool outer;
  explicit Repeat(bool repeat) : outer(opcount::g_repeat) { opcount::g_repeat = outer || repeat; }
  ~Repeat() { opcount::g_repeat = outer; }
};
}  // namespace serl

#define float opcount::Real
#include "control_step.cuh"
#undef float

extern "C" {

// ops[e] = float32 operations of env e's control step, path[e] its critical
// path; `fields` are the 11 PhysicsState inputs (contiguous float32),
// `consts` the kernel's constants, `obstacles` the m boxes' 6 m floats.
void k1_count_ops(float* const* fields, const float* consts, const float* obstacles, int m, int n,
                  int64_t* ops, int64_t* path) {
  static const int widths[11] = {7, 7, 1, 1, 1, 3, 4, 3, 4, 3, 3};
  opcount::Real C[serl::C_COUNT];
  for (int i = 0; i < serl::C_COUNT; ++i) C[i] = opcount::Real::data(consts[i]);
  opcount::Real O[6 * 8];
  for (int i = 0; i < 6 * m; ++i) O[i] = opcount::Real::data(obstacles[i]);
  serl::Group* g = new serl::Group;
  for (int e = 0; e < n; ++e) {
    opcount::Real in[11][7], out[11][7];
    for (int f = 0; f < 11; ++f)
      for (int k = 0; k < widths[f]; ++k) in[f][k] = opcount::Real::data(fields[f][widths[f] * e + k]);
    serl::Fields fi = {in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10]};
    serl::Fields fo = {out[0], out[1], out[2], out[3], out[4], out[5],
                       out[6], out[7], out[8], out[9], out[10]};
    opcount::g_ops = opcount::g_path = opcount::g_phase_max = 0;
    serl::control_step_env(fi, fo, C, O, m, 0, *g);
    ops[e] = opcount::g_ops;
    path[e] = opcount::g_path;
  }
  delete g;
}

}  // extern "C"

#else

namespace serl {
struct Group;
}
static void k1_poison(serl::Group* g);
#define SERL_SUBSTEP_BEGIN(g) k1_poison(&(g))

#include "control_step.cuh"

// Every intermediate of the group (all but the state and the zero vector,
// which a control step sets once) becomes NaN.
static void k1_poison(serl::Group* g) {
  float* first = g->zero + 3;
  std::fill(first, reinterpret_cast<float*>(g + 1), NAN);
}

extern "C" {

// Quotients by serl::div_rcp that differ from x / d in any bit, over n
// random pairs (magnitudes 2^-40 to 2^40, every 1000th dividend a signed
// zero), with the reciprocal from recip(d) and, for d = sqrt(p), from
// rsqrt_rn(p), as the factorisations take it.
int64_t k1_div_mismatches(int64_t n, uint32_t seed) {
  std::mt19937 rng(seed);
  std::uniform_real_distribution<float> unit(-1.0f, 1.0f), mant(0.5f, 2.0f);
  std::uniform_int_distribution<int> expo(-40, 40), half_expo(-20, 20);
  int64_t bad = 0;
  auto same = [](float a, float b) { return std::memcmp(&a, &b, sizeof(float)) == 0; };
  for (int64_t i = 0; i < n; ++i) {
    float x = std::ldexp(unit(rng), expo(rng));
    if (i % 1000 == 0) x = i % 2000 == 0 ? 0.0f : -0.0f;
    float d = std::ldexp(unit(rng), expo(rng));
    if (d == 0.0f) d = 1.0f;
    bad += !same(serl::div_rcp(x, d, serl::recip(d)), x / d);
    const float p = std::ldexp(mant(rng), 2 * half_expo(rng));
    const float root = sqrtf(p);
    bad += !same(serl::div_rcp(x, root, serl::rsqrt_rn(p)), x / root);
  }
  return bad;
}

// One control step of n envs on the CPU: 11 input and 11 output PhysicsState
// fields (contiguous float32), the kernel's constant buffer and the m
// obstacle boxes (6 m floats).
void k1_host_step(float* const* in, float* const* out, const float* consts, const float* obstacles,
                  int m, int n) {
  const serl::Fields fi = {in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10]};
  const serl::Fields fo = {out[0], out[1], out[2], out[3], out[4], out[5],
                           out[6], out[7], out[8], out[9], out[10]};
  serl::Group* g = new serl::Group;
  for (int e = 0; e < n; ++e) serl::control_step_env(fi, fo, consts, obstacles, m, e, *g);
  delete g;
}

}  // extern "C"

#endif
