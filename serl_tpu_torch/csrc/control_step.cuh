// One env's 20 ms control step of the Panda + gripper + cube physics, as
// cooperative fp32 code that a group of 16 lanes runs for one env (see
// control_step.cu).
//
// It follows `control_step_plain` in serl_tpu_torch/envs/physics/engine.py
// step by step: FK, CRBA mass matrix, RNEA bias forces, floor and pad penalty
// contacts, operational-space torques with the det-threshold damping, an
// implicit-damping 7x7 SPD solve, the reduced gripper DOF and the free-body
// cube. Every model and contact constant comes from the float buffer `C`
// (offsets below), which the wrapper packs from the Python constants; the
// only literals here are the numerical guards that math3d.py and engine.py
// also write as literals (1e-12, 1e-9, 1e-8).
//
// How a substep is split. The env's state and every intermediate of a
// substep live in one `Group` (shared memory on the card). A substep is a
// fixed sequence of 16 phases; a phase is `phase(count, f)`: tasks t = 0 ..
// count-1 run f(t), task t on lane t % 16, and then the group syncs. A task
// reads only what earlier phases wrote, and no two tasks of a phase write the
// same entry, so the result does not depend on the order of the lanes, and
// every sum is taken by one lane in a fixed order: two launches on one input
// agree bit for bit. Work that is parallel inside an env goes across
// lanes (link inertias, Jacobian columns, RNEA terms, M's entries, floor
// corners and pad points, the solves' right-hand sides, the task-space
// products); a serial chain stays on one lane, in its registers, where a
// phase per step would cost more in syncs than the step's arithmetic (FK, a
// row a lane; each Cholesky factorisation, whole on a lane, the ones that
// need not wait for each other side by side). Each task does the parent
// code's arithmetic for its entries, in the parent's order, except FK, which
// forms BODY_RMAT[i] Rz(q_i) first, and divisions, which take a reciprocal
// and Markstein's correction (div_rcp: the same quotient).
//
// Nothing here is CUDA-specific beyond SERL_FN and `phase`, so the same
// arithmetic also compiles as host C++ (tests/k1_host.cpp), where `phase`
// runs the lanes as a loop and the group sync is a no-op. A value that
// several lanes compute alike, to save a broadcast, is marked by `Repeat`:
// the counting build counts it on one lane only.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SERL_FN __device__ __forceinline__
#define SERL_UNROLL _Pragma("unroll")
#else
#define SERL_FN inline
#define SERL_UNROLL
#endif

namespace serl {

// Offsets into the constant buffer, in the order of
// engine.py::_kernel_constant_table (tests/test_torch_physics.py checks).
enum : int {
  C_BODY_POS = 0,
  C_BODY_RMAT = C_BODY_POS + 24,
  C_BODY_MASS = C_BODY_RMAT + 72,
  C_BODY_IPOS = C_BODY_MASS + 8,
  C_BODY_INERTIA = C_BODY_IPOS + 24,
  C_ARMATURE = C_BODY_INERTIA + 72,
  C_JOINT_DAMPING = C_ARMATURE + 7,
  C_JNT_LO = C_JOINT_DAMPING + 7,
  C_JNT_HI = C_JNT_LO + 7,
  C_TORQUE_LO = C_JNT_HI + 7,
  C_TORQUE_HI = C_TORQUE_LO + 7,
  C_Q_HOME = C_TORQUE_HI + 7,
  C_PINCH_POS = C_Q_HOME + 7,
  C_PINCH_RMAT = C_PINCH_POS + 3,
  C_GRAVITY = C_PINCH_RMAT + 9,
  C_Y_POLY = C_GRAVITY + 3,
  C_Z_POLY = C_Y_POLY + 4,
  C_DY_POLY = C_Z_POLY + 4,
  C_DZ_POLY = C_DY_POLY + 3,
  C_PAD_HALF_Y = C_DZ_POLY + 3,
  C_PAD_BOX_DZ = C_PAD_HALF_Y + 1,
  C_GRIP_INERTIA = C_PAD_BOX_DZ + 2,
  C_GRIP_DAMPING = C_GRIP_INERTIA + 1,
  C_SPRING_K = C_GRIP_DAMPING + 1,
  C_SPRING_REF = C_SPRING_K + 1,
  C_GRIP_GAIN = C_SPRING_REF + 1,
  C_BIAS_KP = C_GRIP_GAIN + 1,
  C_BIAS_KV = C_BIAS_KP + 1,
  C_F_LO = C_BIAS_KV + 1,
  C_F_HI = C_F_LO + 1,
  C_THETA_LO = C_F_HI + 1,
  C_THETA_HI = C_THETA_LO + 1,
  C_CUBE_MASS = C_THETA_HI + 1,
  C_CUBE_HALF = C_CUBE_MASS + 1,
  C_CUBE_I_DIAG = C_CUBE_HALF + 3,
  C_CORNERS = C_CUBE_I_DIAG + 3,
  C_KN_FLOOR = C_CORNERS + 24,
  C_KD_FLOOR = C_KN_FLOOR + 1,
  C_MU_FLOOR = C_KD_FLOOR + 1,
  C_KN_PAD = C_MU_FLOOR + 1,
  C_KD_PAD = C_KN_PAD + 1,
  C_MU_PAD = C_KD_PAD + 1,
  C_V_EPS = C_MU_PAD + 1,
  C_IMPULSE_CAP = C_V_EPS + 1,
  C_LATERAL_LIMIT = C_IMPULSE_CAP + 1,
  C_KP_POS = C_LATERAL_LIMIT + 3,
  C_KD_POS = C_KP_POS + 1,
  C_KP_ORI = C_KD_POS + 1,
  C_KD_ORI = C_KP_ORI + 1,
  C_KP_NULL = C_KD_ORI + 1,
  C_KD_NULL = C_KP_NULL + 1,
  C_DET_THRESHOLD = C_KD_NULL + 1,
  C_EPS_SINGULAR = C_DET_THRESHOLD + 1,
  C_EPS_REGULAR = C_EPS_SINGULAR + 1,
  C_PIVOT_EPS = C_EPS_REGULAR + 1,
  C_DT = C_PIVOT_EPS + 1,
  C_N_SUBSTEPS = C_DT + 1,
  C_COUNT = C_N_SUBSTEPS + 1,
};

// Pointers to the 11 PhysicsState fields of all envs (row-major, env first).
struct Fields {
  float* qpos;         // (N, 7)
  float* qvel;         // (N, 7)
  float* theta;        // (N,)
  float* dtheta;       // (N,)
  float* grip_ctrl;    // (N,)
  float* mocap_pos;    // (N, 3)
  float* mocap_quat;   // (N, 4)
  float* cube_pos;     // (N, 3)
  float* cube_quat;    // (N, 4)
  float* cube_linvel;  // (N, 3)
  float* cube_angvel;  // (N, 3)
};

// One env's state, in the order of Fields: 37 floats.
struct State {
  float qpos[7], qvel[7], theta, dtheta, grip_ctrl;
  float mocap_pos[3], mocap_quat[4];
  float cube_pos[3], cube_quat[4], cube_linvel[3], cube_angvel[3];
};
constexpr int kStateFloats = 37;
static_assert(sizeof(State) == kStateFloats * sizeof(float), "State is 37 packed floats");

// What one env's group keeps over a control step: the state and a substep's
// intermediates. Link l (0..6) is the body moved by joint l; its frame is
// (p[l + 1], R[l + 1]) and its joint axis R[l + 1]'s column 2 (= S[l][0..2]).
struct Group {
  State s;
  float zero[3];            // a zero vector, for tasks that share one code path
  float B[7][9];            // BODY_RMAT[l + 1] Rz(q_l)
  float p[8][3], R[8][9];   // link frames (index 0, the base, is a constant)
  float pinch[3], PR[9];    // pinch site position and frame
  float Jv[7][3], S[7][6];  // pinch Jacobian's linear rows; motion subspaces [a; o x a]
  float pinch_v[3], pinch_w[3];
  float vJ[7][6], v[7][6], c[7][6], a[7][6];  // RNEA forward pass (qacc = 0)
  float I6[7][6][6], Ic[7][6][6];             // link and composite spatial inertias
  float h[7][6], Ia[7][6], f[7][6], fC[7][6];  // RNEA backward pass
  float F[7][6], bias[7];
  float M[7][7], Md[7][7], L7[7][7], Ld[7][7];  // M, M + dt D and their factors
  float rL7[7], rLd[7];      // 1 / the factors' diagonals
  float X[7][6], A[6][6], L6[6][6], Ls[6][6], Lr[6][6], Mx[6][6];  // Ls, Lr: A + eps I
  float rL6[6], rLs[6], rLr[6];
  float ddx[6], t6[6], Jnull[7][6], P[7][7], ddq[7], tau[7], rhs[7], qacc[7];
  float Rc[9], poly[4];     // cube frame; pad polynomials y, z, dy, dz at theta
  float corner[8][6];       // floor corner k: force, torque on the cube
  float obstacle[8][6];     // corner k against every obstacle box: force, torque
  float pad_geo[4][14];     // pad point k: u, out_w, dpt, r_p, depth, active
  float pad[4][15];         // pad point k: -f, torque on cube, f, torque on arm, f * dpt
  float quat[4], dq[4];     // the pinch frame's quaternion; the cube's rotation increment
  float pad_sum[13];        // f_cube_p, tau_cube_p, f_arm, tau_arm, tau_theta
  float floor_sum[6];       // f_cube, tau_cube
  float cof[9], det3, gyro[3], rhs3[3];  // cube rotational dynamics: I_w's cofactors, det
  float grip0;              // gripper force before the pads' torque
};

// ---------------------------------------------------------------- lanes

// Hooks of the counting build (tests/k1_host.cpp defines them before it
// includes this header); no-ops elsewhere.
#ifndef SERL_COUNT_HOOKS
#define SERL_LANE_BEGIN()
#define SERL_LANE_END()
#define SERL_PHASE_END()
// Marks the arithmetic of its scope as a copy of a value that another lane
// also computes (when `repeat` is true): counted once, on the other lane.
struct Repeat {
  SERL_FN explicit Repeat(bool) {}
};
#endif

// Called as a substep starts; the host build's check (tests/k1_host.cpp)
// fills every intermediate with NaN there, so a task that reads an entry no
// earlier phase wrote gives NaN.
#ifndef SERL_SUBSTEP_BEGIN
#define SERL_SUBSTEP_BEGIN(g)
#endif

// Called after every phase's sync; tests/k1_phase_clocks.py defines it to
// record the cycle counter.
#ifndef SERL_PHASE_CLOCK
#define SERL_PHASE_CLOCK()
#endif

// SERL_NO_OBSTACLES compiles the obstacle contacts out: a launch with no
// obstacles must equal that build bit for bit (chip_smoke.py builds it beside
// the shipped one; tests/torch_k1.py builds it for the host).
#ifdef SERL_NO_OBSTACLES
constexpr bool kObstacles = false;
#else
constexpr bool kObstacles = true;
#endif

// An env's group: half a warp, so a warp issues two envs' tasks at once.
constexpr int kGroupLanes = 16;

// A phase of the group: task t runs on lane t % kGroupLanes. The arm's chain
// takes tasks 0-31 and the cube's, the contacts' and other side work tasks
// 32 and up: the side work runs as later rounds of the same lanes.
#ifdef __CUDACC__
template <class Task>
SERL_FN void phase(int count, Task task) {
  for (int t = (int)(threadIdx.x % kGroupLanes); t < count; t += kGroupLanes) task(t);
  __syncwarp(0xFFFFu << (threadIdx.x & 16));  // this half of the warp
  SERL_PHASE_CLOCK();
}
#else
// The lanes run one after another, from the last to the first, or from the
// first to the last where SERL_HOST_ASCENDING is defined. A task that reads
// what another lane writes in the same phase (a race on the card) reads the
// entry's earlier value, which the host check has made NaN, in one of the
// two orders.
template <class Task>
inline void phase(int count, Task task) {
#ifdef SERL_HOST_ASCENDING
  for (int lane = 0; lane < kGroupLanes; ++lane) {
#else
  for (int lane = kGroupLanes - 1; lane >= 0; --lane) {
#endif
    SERL_LANE_BEGIN();
    for (int t = lane; t < count; t += kGroupLanes) task(t);
    SERL_LANE_END();
  }
  SERL_PHASE_END();
}
#endif

// ---------------------------------------------------------------- helpers

// 1 / d, correctly rounded
SERL_FN float recip(float d) {
#ifdef __CUDACC__
  return __frcp_rn(d);
#else
  return 1.0f / d;
#endif
}

// 1 / sqrt(x), correctly rounded
SERL_FN float rsqrt_rn(float x) {
#if defined(__CUDACC__)
  return __frsqrt_rn(x);
#elif defined(SERL_COUNT_HOOKS)
  return 1.0f / sqrtf(x);
#else
  return (float)(1.0 / sqrt((double)x));
#endif
}

// x / d, correctly rounded, from the reciprocal r = recip(d) or, for d =
// sqrt(p), r = rsqrt_rn(p) (Markstein's correction step: the remainder
// x - q d is exact in one FMA). It equals the IEEE quotient, the sign of a
// zero included (tests/test_torch_k1_lanes.py checks both reciprocals); on the card it takes a few
// FMAs where a division runs a subroutine whose slow path a zero dividend
// takes. The counting build counts it as the division it is.
SERL_FN float div_rcp(float x, float d, float r) {
#ifdef SERL_COUNT_HOOKS
  return x / d;
#else
  const float q = x * r;
  const float rem = fmaf(-q, d, x);
  return rem == 0.0f ? q : fmaf(rem, r, q);
#endif
}

SERL_FN float div_by(float x, float d) {
#ifdef SERL_COUNT_HOOKS
  return x / d;
#else
  return div_rcp(x, d, recip(d));
#endif
}

SERL_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

SERL_FN void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// component k of a x b
SERL_FN float cross_k(const float* a, const float* b, int k) {
  const int i = k == 2 ? 0 : k + 1, j = k == 0 ? 2 : k - 1;
  return a[i] * b[j] - a[j] * b[i];
}

SERL_FN float norm3(const float* v) { return sqrtf(dot3(v, v)); }

// out = A v for row-major 3x3 A
SERL_FN void matvec3(const float* A, const float* v, float* out) {
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) out[r] = A[3 * r] * v[0] + A[3 * r + 1] * v[1] + A[3 * r + 2] * v[2];
}

// out = A^T v for row-major 3x3 A
SERL_FN void matTvec3(const float* A, const float* v, float* out) {
  SERL_UNROLL
  for (int c = 0; c < 3; ++c) out[c] = v[0] * A[c] + v[1] * A[3 + c] + v[2] * A[6 + c];
}

SERL_FN void quat_to_mat(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz); m[2] = 2.0f * (xz + wy);
  m[3] = 2.0f * (xy + wz); m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy); m[7] = 2.0f * (yz + wx); m[8] = 1.0f - 2.0f * (xx + yy);
}

SERL_FN void quat_mul(const float* a, const float* b, float* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

SERL_FN void quat_normalize(float* q) {
  const float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-12f);
  SERL_UNROLL
  for (int k = 0; k < 4; ++k) q[k] = div_by(q[k], n);
}

// branchless Shepperd via the 4-candidate trick (math3d.mat_to_quat)
SERL_FN void mat_to_quat(const float* m, float* q) {
  const float tr = m[0] + m[4] + m[8];
  const float c[4] = {1.0f + tr, 1.0f + m[0] - m[4] - m[8], 1.0f - m[0] + m[4] - m[8],
                      1.0f - m[0] - m[4] + m[8]};
  SERL_UNROLL
  for (int k = 0; k < 4; ++k) q[k] = sqrtf(fmaxf(c[k], 1e-12f)) / 2.0f;
  q[1] = copysignf(q[1], m[7] - m[5]);
  q[2] = copysignf(q[2], m[2] - m[6]);
  q[3] = copysignf(q[3], m[3] - m[1]);
  quat_normalize(q);
}

// log map with the small-angle limit (math3d.quat_to_axis_angle)
SERL_FN void quat_to_axis_angle(const float* q_in, float* out) {
  const float sgn = q_in[0] < 0.0f ? -1.0f : 1.0f;
  const float w = fminf(fmaxf(sgn * q_in[0], -1.0f), 1.0f);
  const float v[3] = {sgn * q_in[1], sgn * q_in[2], sgn * q_in[3]};
  const float sin_half = norm3(v);
  const float angle = 2.0f * atan2f(sin_half, w);
  const float scale = sin_half < 1e-8f ? 2.0f : div_by(angle, fmaxf(sin_half, 1e-12f));
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) out[k] = v[k] * scale;
}

// q' = exp(dt/2 * omega) * q (math3d.quat_integrate), in two steps: the
// increment dq = exp(dt/2 * omega), then q' = normalize(dq q)
SERL_FN void quat_increment(const float* omega, float dt, float* dq) {
  const float angle = norm3(omega);
  const float inv = fmaxf(angle, 1e-12f);
  const float half = (angle * dt) * 0.5f;
  const float s = sinf(half);
  dq[0] = cosf(half);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) dq[k + 1] = div_by(omega[k], inv) * s;
}

SERL_FN void quat_apply(const float* dq, float* q) {
  float out[4];
  quat_mul(dq, q, out);
  quat_normalize(out);
  SERL_UNROLL
  for (int k = 0; k < 4; ++k) q[k] = out[k];
}

// Horner, highest power first (gripper.polyval)
template <int K>
SERL_FN float polyval(const float* c, float x) {
  float y = 0.0f;
  SERL_UNROLL
  for (int k = 0; k < K; ++k) y = y * x + c[k];
  return y;
}

// L = chol(A + shift I) with the pivot clamp (linalg_small.chol_unrolled,
// L lower), on one lane and in its registers, in the parent code's order;
// rdiag = 1 / L's diagonal for the solves. shift is a literal 0 where A is
// factored as it is.
template <int N>
SERL_FN void chol(const float (*A)[N], float shift, float (*L)[N], float* rdiag,
                  float pivot_eps) {
  float l[N][N], r[N];
  SERL_UNROLL
  for (int i = 0; i < N; ++i) {
    SERL_UNROLL
    for (int j = 0; j <= i; ++j) {
      float s = i == j ? A[i][j] + shift : A[i][j];
      SERL_UNROLL
      for (int k = 0; k < j; ++k) s = s - l[i][k] * l[j][k];
      if (i == j) {
        // the reciprocal from the pivot itself, beside the square root and
        // not after it; div_rcp's correction step is exact with it as well
        const float pivot = fmaxf(s, pivot_eps);
        l[i][i] = sqrtf(pivot);
        const Repeat rep(true);  // stands in for the divisions, counted where they are
        r[i] = rsqrt_rn(pivot);
      } else {
        l[i][j] = div_rcp(s, l[j][j], r[j]);
      }
    }
  }
  SERL_UNROLL
  for (int i = 0; i < N; ++i) {
    rdiag[i] = r[i];
    SERL_UNROLL
    for (int j = 0; j <= i; ++j) L[i][j] = l[i][j];
  }
}

// x = (L L^T)^-1 b, on one lane; rdiag holds 1 / L[i][i]
template <int N>
SERL_FN void chol_solve(const float (*L)[N], const float* rdiag, const float* b, float* x) {
  float y[N];
  SERL_UNROLL
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    SERL_UNROLL
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = div_rcp(s, L[i][i], rdiag[i]);
  }
  SERL_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    SERL_UNROLL
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = div_rcp(s, L[i][i], rdiag[i]);
  }
}

// Regularized Coulomb friction capped at the velocity-matching impulse
// (engine._friction): adds the friction force for tangential velocity vt.
SERL_FN void friction(float fn_mag, const float* vt, float mu, const float* C, float* f) {
  const float vt_norm = norm3(vt);
  const float ft_mag = fminf(mu * fn_mag * tanhf(div_by(vt_norm, C[C_V_EPS])),
                             div_by(C[C_IMPULSE_CAP] * vt_norm, C[C_DT]));
  const float d = fmaxf(vt_norm, 1e-9f);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) f[k] = f[k] + div_by(-ft_mag * vt[k], d);
}

// Rows r and 3 + r of the spatial inertia (6x6, [w; v] at the world origin)
// of moving link l (1..7); the link's three row lanes each form its centre of
// mass, counted on row 0's lane.
SERL_FN void link_inertia_rows(int l, int r, const float* p, const float* R, const float* C,
                               float (*I6)[6]) {
  float com[3];
  {
    const Repeat rep(r != 0);
    matvec3(R, C + C_BODY_IPOS + 3 * l, com);
    SERL_UNROLL
    for (int k = 0; k < 3; ++k) com[k] = p[k] + com[k];
  }
  const float* I_local = C + C_BODY_INERTIA + 9 * l;
  float tmp[3], Iw[3];
  SERL_UNROLL
  for (int c = 0; c < 3; ++c)  // row r of R @ I_local
    tmp[c] = R[3 * r] * I_local[c] + R[3 * r + 1] * I_local[3 + c] + R[3 * r + 2] * I_local[6 + c];
  SERL_UNROLL
  for (int c = 0; c < 3; ++c)  // row r of tmp @ R^T
    Iw[c] = tmp[0] * R[3 * c] + tmp[1] * R[3 * c + 1] + tmp[2] * R[3 * c + 2];
  const float m = C[C_BODY_MASS + l];
  const float S[9] = {0.0f, -com[2], com[1], com[2], 0.0f, -com[0], -com[1], com[0], 0.0f};
  SERL_UNROLL
  for (int c = 0; c < 3; ++c) {
    const float sst = S[3 * r] * S[3 * c] + S[3 * r + 1] * S[3 * c + 1] + S[3 * r + 2] * S[3 * c + 2];
    I6[r][c] = Iw[c] + m * sst;
    I6[r][3 + c] = m * S[3 * r + c];
    I6[3 + r][c] = m * S[3 * c + r];
    I6[3 + r][3 + c] = r == c ? m : 0.0f;
  }
}

// Row r of forward kinematics and of the pinch frame, on one lane and in its
// registers: row r of R_i = R_{i-1} B and p_i[r] = p_{i-1}[r] + (R_{i-1} b)[r]
// need only row r of R_{i-1}, so the three rows run on three lanes with
// nothing to exchange, each serial over the 7 links (a phase per link would
// cost more in syncs than the link's three-term dot products).
SERL_FN void forward_kinematics_row(Group& g, int r, const float* C) {
  float p = C[C_BODY_POS + r], row[3];
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) row[k] = C[C_BODY_RMAT + 3 * r + k];
  SERL_UNROLL
  for (int i = 1; i < 9; ++i) {
    const float* b = i < 8 ? C + C_BODY_POS + 3 * i : C + C_PINCH_POS;
    const float* B = i < 8 ? g.B[i - 1] : C + C_PINCH_RMAT;
    float next[3];
    SERL_UNROLL
    for (int c = 0; c < 3; ++c) next[c] = row[0] * B[c] + row[1] * B[3 + c] + row[2] * B[6 + c];
    p = p + (row[0] * b[0] + row[1] * b[1] + row[2] * b[2]);
    float* p_out = i < 8 ? g.p[i] : g.pinch;
    float* R_out = i < 8 ? g.R[i] : g.PR;
    p_out[r] = p;
    SERL_UNROLL
    for (int c = 0; c < 3; ++c) R_out[3 * r + c] = row[c] = next[c];
  }
}

// Row i of the task-space Jacobian's transpose: JT[i] = [Jv_i; a_i]
SERL_FN float jt(const Group& g, int i, int c) { return c < 3 ? g.Jv[i][c] : g.S[i][c - 3]; }

// (i, j), i <= j, of upper-triangle entry t of a 7x7 matrix, row by row
SERL_FN void upper_entry(int t, int& i, int& j) {
  i = 0;
  while (t >= 7 - i) {
    t -= 7 - i;
    ++i;
  }
  j = i + t;
}

// ---------------------------------------------------------------- phases

// Floor corner k's penalty contact: force and torque on the cube
SERL_FN void floor_corner(const Group& g, int k, const float* C, float* out) {
  const State& s = g.s;
  float cw[3], r[3], v[3], wr[3];
  matvec3(g.Rc, C + C_CORNERS + 3 * k, cw);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) cw[d] = s.cube_pos[d] + cw[d];
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) r[d] = cw[d] - s.cube_pos[d];
  cross3(s.cube_angvel, r, wr);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) v[d] = s.cube_linvel[d] + wr[d];
  const float depth = -cw[2];
  float fn = depth > 0.0f ? C[C_KN_FLOOR] * depth - C[C_KD_FLOOR] * v[2] : 0.0f;
  fn = fmaxf(fn, 0.0f);
  float f[3] = {0.0f, 0.0f, fn};
  const float vt[3] = {v[0], v[1], 0.0f};
  friction(fn, vt, C[C_MU_FLOOR], C, f);
  float t[3];
  cross3(r, f, t);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) {
    out[d] = f[d];
    out[3 + d] = t[d];
  }
}

// Cube corner k against the m static boxes of `O` ((lo, hi) as 6 floats a
// box, world frame; the bin walls): for each box that holds the corner
// strictly inside, a penalty contact along the face of least penetration
// (the first axis on a tie; along +axis where the axis' two faces are
// equally near) with the floor's constants and friction, summed over the
// boxes in order. The corner's position and velocity repeat floor_corner's.
SERL_FN void obstacle_corner(const Group& g, int k, const float* O, int m, const float* C,
                             float* out) {
  const State& s = g.s;
  float cw[3], r[3], v[3];
  {
    const Repeat rep(true);
    float wr[3];
    matvec3(g.Rc, C + C_CORNERS + 3 * k, cw);
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) cw[d] = s.cube_pos[d] + cw[d];
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) r[d] = cw[d] - s.cube_pos[d];
    cross3(s.cube_angvel, r, wr);
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) v[d] = s.cube_linvel[d] + wr[d];
  }
  float sum[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < m; ++j) {
    const float* lo = O + 6 * j;
    const float* hi = lo + 3;
    float depth_axis[3], sign[3];
    bool inside = true;
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) {
      const float d_lo = cw[d] - lo[d], d_hi = hi[d] - cw[d];
      inside = inside && d_lo > 0.0f && d_hi > 0.0f;
      depth_axis[d] = fminf(d_lo, d_hi);
      sign[d] = d_lo < d_hi ? -1.0f : 1.0f;
    }
    if (!inside) continue;
    // the normal: +-e_ax, ax the first axis of least depth
    const int ax = depth_axis[1] < depth_axis[0]
                       ? (depth_axis[2] < depth_axis[1] ? 2 : 1)
                       : (depth_axis[2] < depth_axis[0] ? 2 : 0);
    float depth = depth_axis[0], vn = v[0] * sign[0], s_ax = sign[0];
    SERL_UNROLL
    for (int d = 1; d < 3; ++d) {
      if (d == ax) {
        depth = depth_axis[d];
        vn = v[d] * sign[d];
        s_ax = sign[d];
      }
    }
    float fn = C[C_KN_FLOOR] * depth - C[C_KD_FLOOR] * vn;
    fn = fmaxf(fn, 0.0f);
    float f[3], vt[3];
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) {
      // vt = v - vn * normal: v off the normal's axis, exactly zero along it
      f[d] = d == ax ? fn * s_ax : 0.0f;
      vt[d] = d == ax ? 0.0f : v[d];
    }
    friction(fn, vt, C[C_MU_FLOOR], C, f);
    float t[3];
    cross3(r, f, t);
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) {
      sum[d] = sum[d] + f[d];
      sum[3 + d] = sum[3 + d] + t[d];
    }
  }
  SERL_UNROLL
  for (int d = 0; d < 6; ++d) out[d] = sum[d];
}

// Pad point k (plane vs box along the closing axis), in two steps. The
// geometry, from the pinch frame and the cube's pose: u, the outward normal
// out_w, dpt, r_p, the depth and whether the contact is active.
SERL_FN void pad_geometry(const Group& g, int k, const float* C, float* out) {
  const State& s = g.s;
  float y_face;
  {
    const Repeat r(k != 0);
    y_face = g.poly[0] - C[C_PAD_HALF_Y];
  }
  const float z = g.poly[1], dy = g.poly[2], dz = g.poly[3];
  const float side = k < 2 ? 1.0f : -1.0f;  // right (+y), left (-y)
  const float local[3] = {0.0f, side * y_face, z + C[C_PAD_BOX_DZ + (k & 1)]};
  const float normal[3] = {0.0f, -side, 0.0f};
  const float jac[3] = {0.0f, side * dy, dz};
  float pw[3], out_w[3], dpt[3], u[3], xi[3], ac[3];
  matvec3(g.PR, local, pw);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) pw[d] = g.pinch[d] + pw[d];
  matvec3(g.PR, normal, out_w);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) out_w[d] = -out_w[d];
  matvec3(g.PR, jac, dpt);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) u[d] = pw[d] - s.cube_pos[d];
  matTvec3(g.Rc, u, xi);
  bool lateral_ok = true;
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) lateral_ok = lateral_ok && fabsf(xi[d]) < C[C_LATERAL_LIMIT + d];
  matTvec3(g.Rc, out_w, ac);
  const float support = fabsf(ac[0]) * C[C_CUBE_HALF] + fabsf(ac[1]) * C[C_CUBE_HALF + 1] +
                        fabsf(ac[2]) * C[C_CUBE_HALF + 2];
  const float d_axis = dot3(u, out_w);
  const float depth = support - d_axis;
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) {
    out[d] = u[d];
    out[3 + d] = out_w[d];
    out[6 + d] = dpt[d];
    out[9 + d] = pw[d] - g.pinch[d];  // r_p
  }
  out[12] = depth;
  out[13] = lateral_ok && depth > 0.0f && d_axis > 0.0f ? 1.0f : 0.0f;
}

// The forces, from pad_geometry's `geo` and the velocities: -f (on the
// cube), the torque on the cube, f (on the pad), the torque on the arm, f * dpt
SERL_FN void pad_force(const Group& g, const float* geo, const float* C, float* out) {
  const State& s = g.s;
  const float *u = geo, *out_w = geo + 3, *dpt = geo + 6, *r_p = geo + 9;
  float wc[3], wp[3], v_rel[3];
  cross3(s.cube_angvel, u, wc);
  cross3(g.pinch_w, r_p, wp);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) {
    const float v_pad = g.pinch_v[d] + wp[d] + dpt[d] * s.dtheta;
    const float v_cube = s.cube_linvel[d] + wc[d];
    v_rel[d] = v_pad - v_cube;
  }
  const float vn = dot3(v_rel, out_w);
  float fn = geo[13] > 0.0f ? C[C_KN_PAD] * geo[12] - C[C_KD_PAD] * vn : 0.0f;
  fn = fmaxf(fn, 0.0f);
  float f[3], vt[3];
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) {
    f[d] = fn * out_w[d];
    vt[d] = v_rel[d] - vn * out_w[d];
  }
  friction(fn, vt, C[C_MU_PAD], C, f);  // f: force ON the pad
  float nf[3] = {-f[0], -f[1], -f[2]};
  float tc[3], ta[3];
  cross3(u, nf, tc);
  cross3(r_p, f, ta);
  SERL_UNROLL
  for (int d = 0; d < 3; ++d) {
    out[d] = nf[d];
    out[3 + d] = tc[d];
    out[6 + d] = f[d];
    out[9 + d] = ta[d];
    out[12 + d] = f[d] * dpt[d];
  }
}

// The orientation half of the task-space acceleration, ddx[3..5], from the
// pinch frame's quaternion g.quat (mat_to_quat of PR, the step before)
SERL_FN void orientation_error(Group& g, const float* C) {
  const State& s = g.s;
  float quat[4], qc[4], q_err[4], ori_err[3];
  SERL_UNROLL
  for (int k = 0; k < 4; ++k) quat[k] = g.quat[k];
  const float qd = quat[0] * s.mocap_quat[0] + quat[1] * s.mocap_quat[1] +
                   quat[2] * s.mocap_quat[2] + quat[3] * s.mocap_quat[3];
  if (qd < 0.0f) {
    SERL_UNROLL
    for (int k = 0; k < 4; ++k) quat[k] = -quat[k];
  }
  qc[0] = s.mocap_quat[0];
  SERL_UNROLL
  for (int k = 1; k < 4; ++k) qc[k] = -s.mocap_quat[k];
  quat_mul(quat, qc, q_err);
  quat_to_axis_angle(q_err, ori_err);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) g.ddx[3 + k] = -C[C_KP_ORI] * ori_err[k] - C[C_KD_ORI] * g.pinch_w[k];
}

// ---------------------------------------------------------------- substep

// The cube's frame, its world inertia with the inertia's cofactors and
// determinant, and its gyroscopic term, on one lane
SERL_FN void cube_frame(Group& g, const float* C) {
  const State& s = g.s;
  quat_to_mat(s.cube_quat, g.Rc);
  const float* Rc = g.Rc;
  float Iw[9];
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) {
    SERL_UNROLL
    for (int c = 0; c < 3; ++c)
      Iw[3 * r + c] = Rc[3 * r] * C[C_CUBE_I_DIAG] * Rc[3 * c] +
                      Rc[3 * r + 1] * C[C_CUBE_I_DIAG + 1] * Rc[3 * c + 1] +
                      Rc[3 * r + 2] * C[C_CUBE_I_DIAG + 2] * Rc[3 * c + 2];
  }
  cross3(Iw + 3, Iw + 6, g.cof);
  g.det3 = dot3(Iw, g.cof);
  cross3(Iw + 6, Iw, g.cof + 3);
  cross3(Iw, Iw + 3, g.cof + 6);
  float Iwv[3];
  matvec3(Iw, s.cube_angvel, Iwv);
  cross3(s.cube_angvel, Iwv, g.gyro);
}

// A substep: 16 phases. Each comment names the phase's tasks, the side work
// on tasks 32 and up after the bar.
SERL_FN void substep(Group& g, const float* __restrict__ C, const float* __restrict__ O, int m) {
  SERL_SUBSTEP_BEGIN(g);
  State& s = g.s;
  const float dt = C[C_DT];
  const float pivot_eps = C[C_PIVOT_EPS];

  // joint rotations B_l = BODY_RMAT[l + 1] Rz(q_l) | the cube's frame and
  // inertia, the gripper's drive and the pad polynomials at theta; the
  // nullspace joint PD
  phase(40, [&](int t) {
    if (t < 7) {
      const float cq = cosf(s.qpos[t]), sq = sinf(s.qpos[t]);
      const float* Bf = C + C_BODY_RMAT + 9 * (t + 1);
      SERL_UNROLL
      for (int r = 0; r < 3; ++r) {
        g.B[t][3 * r] = Bf[3 * r] * cq + Bf[3 * r + 1] * sq;
        g.B[t][3 * r + 1] = Bf[3 * r] * -sq + Bf[3 * r + 1] * cq;
        g.B[t][3 * r + 2] = Bf[3 * r + 2];
      }
    } else if (t == 32) {
      cube_frame(g, C);
      float f_act = C[C_GRIP_GAIN] * s.grip_ctrl - C[C_BIAS_KP] * s.theta - C[C_BIAS_KV] * s.dtheta;
      f_act = fminf(fmaxf(f_act, C[C_F_LO]), C[C_F_HI]);
      const float f_spring = C[C_SPRING_K] * (C[C_SPRING_REF] - s.theta);
      g.grip0 = f_act + f_spring - C[C_GRIP_DAMPING] * s.dtheta;
      g.poly[0] = polyval<4>(C + C_Y_POLY, s.theta);
      g.poly[1] = polyval<4>(C + C_Z_POLY, s.theta);
      g.poly[2] = polyval<3>(C + C_DY_POLY, s.theta);
      g.poly[3] = polyval<3>(C + C_DZ_POLY, s.theta);
    } else if (t > 32) {
      const int j = t - 33;
      g.ddq[j] = -C[C_KP_NULL] * (s.qpos[j] - C[C_Q_HOME + j]) - C[C_KD_NULL] * s.qvel[j];
    }
  });

  // forward kinematics and the pinch frame, a row a lane | the floor
  // corners' contacts; with obstacles, the corners' contacts with them on
  // the third round's idle lanes (tasks 40-47)
  phase(kObstacles && m > 0 ? 48 : 40, [&](int t) {
    if (t < 3) {
      forward_kinematics_row(g, t, C);
    } else if (t >= 40) {
      obstacle_corner(g, t - 40, O, m, C, g.obstacle[t - 40]);
    } else if (t >= 32) {
      floor_corner(g, t - 32, C, g.corner[t - 32]);
    }
  });

  // motion subspaces S_l = [a_l; o_l x a_l]; pinch_w; link inertias, rows r
  // and 3 + r on lane (link, r) | the floor forces summed; the pinch frame's
  // quaternion; the pad points' geometry
  phase(43, [&](int t) {
    if (t < 7) {
      const float ax[3] = {g.R[t + 1][2], g.R[t + 1][5], g.R[t + 1][8]};
      SERL_UNROLL
      for (int k = 0; k < 3; ++k) g.S[t][k] = ax[k];
      cross3(g.p[t + 1], ax, &g.S[t][3]);
    } else if (t < 10) {
      const int r = t - 7;
      float sw = 0.0f;
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) sw = sw + g.R[i + 1][3 * r + 2] * s.qvel[i];
      g.pinch_w[r] = sw;
    } else if (t < 31) {
      const int l = (t - 10) / 3;
      link_inertia_rows(l + 1, (t - 10) % 3, g.p[l + 1], g.R[l + 1], C, g.I6[l]);
    } else if (t >= 32 && t < 38) {
      const int d = t - 32;
      float sum = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 8; ++k) sum = sum + g.corner[k][d];
      if (kObstacles && m > 0) {
        float obs = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 8; ++k) obs = obs + g.obstacle[k][d];
        sum = sum + obs;
      }
      g.floor_sum[d] = sum;
    } else if (t == 38) {
      mat_to_quat(g.PR, g.quat);
    } else if (t > 38) {
      pad_geometry(g, t - 39, C, g.pad_geo[t - 39]);
    }
  });

  // pinch Jacobian columns; link velocities (a prefix sum per component);
  // composite inertias (suffix sums, two entries a lane) | the orientation
  // half of the task-space acceleration
  phase(33, [&](int t) {
    if (t < 7) {
      const float d[3] = {g.pinch[0] - g.p[t + 1][0], g.pinch[1] - g.p[t + 1][1],
                          g.pinch[2] - g.p[t + 1][2]};
      cross3(g.S[t], d, g.Jv[t]);
    } else if (t < 13) {
      const int k = t - 7;
      float v = 0.0f;
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) {
        g.vJ[i][k] = g.S[i][k] * s.qvel[i];
        v = v + g.vJ[i][k];
        g.v[i][k] = v;
      }
    } else if (t < 31) {
      SERL_UNROLL
      for (int q = t - 13; q < 36; q += 18) {
        const int r = q / 6, c = q % 6;
        float ic = 0.0f;
        SERL_UNROLL
        for (int i = 6; i >= 0; --i) {
          ic = ic + g.I6[i][r][c];
          g.Ic[i][r][c] = ic;
        }
      }
    } else if (t == 32) {
      orientation_error(g, C);
    }
  });

  // crm(v_l) vJ_l, three components on lane (link, half); pinch_v; F_l =
  // Ic_l S_l, three rows on lane (link, half)
  phase(31, [&](int t) {
    if (t < 14) {
      // half 0: w x vJ_w (+ 0 x vJ_v); half 1: vo x vJ_w + w x vJ_v, one code path
      const int i = t / 2, half = t % 2;
      const float *v = g.v[i], *vJ = g.vJ[i];
      const float* a = half == 0 ? v : v + 3;
      const float* w = half == 0 ? g.zero : v;
      SERL_UNROLL
      for (int k = 0; k < 3; ++k) g.c[i][3 * half + k] = cross_k(a, vJ, k) + cross_k(w, vJ + 3, k);
    } else if (t < 17) {
      const int r = t - 14;
      float sv = 0.0f;
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) sv = sv + g.Jv[i][r] * s.qvel[i];
      g.pinch_v[r] = sv;
    } else {
      const int i = (t - 17) / 2, k0 = 3 * ((t - 17) % 2);
      SERL_UNROLL
      for (int k = k0; k < k0 + 3; ++k) {
        float fk = 0.0f;
        SERL_UNROLL
        for (int c = 0; c < 6; ++c) fk = fk + g.Ic[i][k][c] * g.S[i][c];
        g.F[i][k] = fk;
      }
    }
  });

  // link accelerations (a prefix sum per component); the position half of
  // the task-space acceleration; M and M + dt D, two upper entries a lane |
  // the pad forces
  phase(36, [&](int t) {
    if (t < 6) {
      float a = t < 3 ? 0.0f : -C[C_GRAVITY + t - 3];
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) {
        a = a + g.c[i][t];
        g.a[i][t] = a;
      }
    } else if (t < 9) {
      const int k = t - 6;
      g.ddx[k] = -C[C_KP_POS] * (g.pinch[k] - s.mocap_pos[k]) - C[C_KD_POS] * g.pinch_v[k];
    } else if (t < 23) {
      SERL_UNROLL
      for (int q = t - 9; q < 28; q += 14) {
        int i, j;
        upper_entry(q, i, j);
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 6; ++k) m = m + g.S[i][k] * g.F[j][k];
        m = i == j ? m + C[C_ARMATURE + i] : m;
        g.M[i][j] = g.M[j][i] = m;
        g.Md[i][j] = g.Md[j][i] = i == j ? m + dt * C[C_JOINT_DAMPING + i] : m;
      }
    } else if (t >= 32) {
      pad_force(g, g.pad_geo[t - 32], C, g.pad[t - 32]);
    }
  });

  // I_l v_l and I_l a_l, three rows on lane (link, half); chol(M) and
  // chol(M + dt D), each whole on one lane | the pad sums
  phase(45, [&](int t) {
    if (t < 14) {
      const int i = t / 2, k0 = 3 * (t % 2);
      SERL_UNROLL
      for (int k = k0; k < k0 + 3; ++k) {
        float hk = 0.0f, iak = 0.0f;
        SERL_UNROLL
        for (int c = 0; c < 6; ++c) {
          hk = hk + g.I6[i][k][c] * g.v[i][c];
          iak = iak + g.I6[i][k][c] * g.a[i][c];
        }
        g.h[i][k] = hk;
        g.Ia[i][k] = iak;
      }
    } else if (t < 16) {
      const bool damped = t == 15;
      chol<7>(damped ? g.Md : g.M, 0.0f, damped ? g.Ld : g.L7, damped ? g.rLd : g.rL7, pivot_eps);
    } else if (t >= 32) {
      const int q = t - 32;  // 0..11: the four vectors' components; 12: tau_theta
      float sum = 0.0f;
      if (q < 12) {
        SERL_UNROLL
        for (int k = 0; k < 4; ++k) sum = sum + g.pad[k][q];
      } else {
        SERL_UNROLL
        for (int k = 0; k < 4; ++k) {
          SERL_UNROLL
          for (int d = 0; d < 3; ++d) sum = sum + g.pad[k][12 + d];
        }
      }
      g.pad_sum[q] = sum;
    }
  });

  // link forces f_l = I a + crf(v) I v, three components on lane (link,
  // half); X = M^-1 Jfull^T (7x6), one Cholesky solve per column | the
  // cube's rotational right-hand side
  phase(35, [&](int t) {
    if (t < 14) {
      // half 0: Ia + (w x h_w + vo x h_v); half 1: Ia + (w x h_v + 0 x h_v)
      const int i = t / 2, half = t % 2;
      const float *v = g.v[i], *h = g.h[i];
      const float* b = half == 0 ? h : h + 3;
      const float* o = half == 0 ? v + 3 : g.zero;
      SERL_UNROLL
      for (int k = 0; k < 3; ++k)
        g.f[i][3 * half + k] = g.Ia[i][3 * half + k] + (cross_k(v, b, k) + cross_k(o, h + 3, k));
    } else if (t < 20) {
      const int c = t - 14;
      float b[7], x[7];
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) b[i] = jt(g, i, c);
      chol_solve<7>(g.L7, g.rL7, b, x);
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) g.X[i][c] = x[i];
    } else if (t >= 32) {
      const int d = t - 32;
      g.rhs3[d] = (g.floor_sum[3 + d] + g.pad_sum[3 + d]) - g.gyro[d];
    }
  });

  // fC (suffix sums of f); Mx_inv = Jfull X (6x6), two entries a lane | the
  // cube's velocities and position; the gripper DOF (semi-implicit Euler,
  // range clamp with velocity kill)
  phase(36, [&](int t) {
    if (t < 6) {
      float acc = 0.0f;
      SERL_UNROLL
      for (int i = 6; i >= 0; --i) {
        acc = acc + g.f[i][t];
        g.fC[i][t] = acc;
      }
    } else if (t < 24) {
      SERL_UNROLL
      for (int q = t - 6; q < 36; q += 18) {
        const int r = q / 6, c = q % 6;
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 7; ++k) m = m + jt(g, k, r) * g.X[k][c];
        g.A[r][c] = m;
      }
    } else if (t >= 32 && t < 35) {
      const int d = t - 32;
      const float m = C[C_CUBE_MASS];
      const float f = g.floor_sum[d] + g.pad_sum[d] + m * C[C_GRAVITY + d];
      const float linvel = s.cube_linvel[d] + div_by(dt * f, m);
      const float dw = div_by(
          g.cof[d] * g.rhs3[0] + g.cof[3 + d] * g.rhs3[1] + g.cof[6 + d] * g.rhs3[2], g.det3);
      s.cube_angvel[d] = s.cube_angvel[d] + dt * dw;
      s.cube_linvel[d] = linvel;
      s.cube_pos[d] = s.cube_pos[d] + dt * linvel;
    } else if (t == 35) {
      const float acc = div_by(g.grip0 + g.pad_sum[12], C[C_GRIP_INERTIA]);
      const float dth = s.dtheta + dt * acc;
      const float th = s.theta + dt * dth;
      const float clamped = fminf(fmaxf(th, C[C_THETA_LO]), C[C_THETA_HI]);
      s.dtheta = clamped == th ? dth : 0.0f;
      s.theta = clamped;
    }
  });

  // bias forces S_l . fC_l; chol(A), which gives the det, and chol(A + eps I)
  // for both of the det-threshold damping's eps, each whole on one lane (the
  // one that the det picks is counted) | the cube's rotation increment
  phase(33, [&](int t) {
    if (t < 7) {
      float proj = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) proj = proj + g.S[t][k] * g.fC[t][k];
      g.bias[t] = proj;
    } else if (t < 10) {
      const int which = t - 7;
      const Repeat spare(which == 1);
      const float shift = which == 0 ? 0.0f : C[which == 1 ? C_EPS_SINGULAR : C_EPS_REGULAR];
      chol<6>(g.A, shift, which == 0 ? g.L6 : which == 1 ? g.Ls : g.Lr,
              which == 0 ? g.rL6 : which == 1 ? g.rLs : g.rLr, pivot_eps);
    } else if (t == 32) {
      quat_increment(s.cube_angvel, dt, g.dq);
    }
  });

  // Mx = (A + eps I)^-1, one solve per column, eps picked by the det of
  // chol(A) | the cube's orientation
  phase(33, [&](int t) {
    if (t < 6) {
      float det;
      {
        const Repeat r(t != 0);
        det = g.L6[0][0] * g.L6[0][0];
        SERL_UNROLL
        for (int k = 1; k < 6; ++k) det = det * (g.L6[k][k] * g.L6[k][k]);
      }
      const bool singular = fabsf(det) < C[C_DET_THRESHOLD];
      float e[6], x[6];
      SERL_UNROLL
      for (int i = 0; i < 6; ++i) e[i] = i == t ? 1.0f : 0.0f;
      chol_solve<6>(singular ? g.Ls : g.Lr, singular ? g.rLs : g.rLr, e, x);
      SERL_UNROLL
      for (int i = 0; i < 6; ++i) g.Mx[i][t] = x[i];
    } else if (t == 32) {
      quat_apply(g.dq, s.cube_quat);
    }
  });
  // t6 = Mx ddx; Jnull = X Mx, two entries a lane
  phase(27, [&](int t) {
    if (t < 6) {
      float m = 0.0f;
      SERL_UNROLL
      for (int c = 0; c < 6; ++c) m = m + g.Mx[t][c] * g.ddx[c];
      g.t6[t] = m;
    } else {
      const int i = (t - 6) / 3, c0 = 2 * ((t - 6) % 3);
      SERL_UNROLL
      for (int c = c0; c < c0 + 2; ++c) {
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 6; ++k) m = m + g.X[i][k] * g.Mx[k][c];
        g.Jnull[i][c] = m;
      }
    }
  });
  // the projector's entries P = Jfull^T Jnull^T, two a lane | tau = Jfull^T t6
  phase(39, [&](int t) {
    if (t < 25) {
      SERL_UNROLL
      for (int q = t; q < 49; q += 25) {
        const int i = q / 7, j = q % 7;
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 6; ++k) m = m + jt(g, i, k) * g.Jnull[j][k];
        g.P[i][j] = m;
      }
    } else if (t >= 32) {
      const int i = t - 32;
      float m = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) m = m + jt(g, i, k) * g.t6[k];
      g.tau[i] = m;
    }
  });
  // nullspace joint PD tau += (I - P) ddq, the clamp, and the arm's
  // right-hand side with the contact reaction through the pinch Jacobian
  phase(7, [&](int i) {
    float m = 0.0f;
    SERL_UNROLL
    for (int j = 0; j < 7; ++j) m = m + ((i == j ? 1.0f : 0.0f) - g.P[i][j]) * g.ddq[j];
    const float tau =
        fminf(fmaxf((g.tau[i] + m) + g.bias[i], C[C_TORQUE_LO + i]), C[C_TORQUE_HI + i]);
    const float* tau_arm = g.pad_sum + 9;
    const float* f_arm = g.pad_sum + 6;
    const float ext = g.S[i][0] * tau_arm[0] + g.S[i][1] * tau_arm[1] + g.S[i][2] * tau_arm[2] +
                      g.Jv[i][0] * f_arm[0] + g.Jv[i][1] * f_arm[1] + g.Jv[i][2] * f_arm[2];
    g.rhs[i] = tau + ext - g.bias[i] - C[C_JOINT_DAMPING + i] * s.qvel[i];
  });

  // ---- arm integration with implicit joint damping ----
  phase(1, [&](int) { chol_solve<7>(g.Ld, g.rLd, g.rhs, g.qacc); });
  phase(7, [&](int i) {
    const float qv = s.qvel[i] + dt * g.qacc[i];
    const float q = s.qpos[i] + dt * qv;
    const float clamped = fminf(fmaxf(q, C[C_JNT_LO + i]), C[C_JNT_HI + i]);
    s.qvel[i] = clamped == q ? qv : 0.0f;
    s.qpos[i] = clamped;
  });
}

// ---------------------------------------------------------------- env step

// Float t (0..36) of env e's state in `f`, in the order of State
SERL_FN float* state_entry(const Fields& f, int e, int t) {
  if (t < 7) return f.qpos + 7 * e + t;
  if (t < 14) return f.qvel + 7 * e + t - 7;
  if (t == 14) return f.theta + e;
  if (t == 15) return f.dtheta + e;
  if (t == 16) return f.grip_ctrl + e;
  if (t < 20) return f.mocap_pos + 3 * e + t - 17;
  if (t < 24) return f.mocap_quat + 4 * e + t - 20;
  if (t < 27) return f.cube_pos + 3 * e + t - 24;
  if (t < 31) return f.cube_quat + 4 * e + t - 27;
  if (t < 34) return f.cube_linvel + 3 * e + t - 31;
  return f.cube_angvel + 3 * e + t - 34;
}

// Env e: its group of lanes reads its state from `in`, runs the substeps
// against the m obstacle boxes of `O` (6 floats a box; m = 0: none) and
// writes the state to `out`.
SERL_FN void control_step_env(const Fields& in, const Fields& out, const float* __restrict__ C,
                              const float* __restrict__ O, int m, int e, Group& g) {
  float* state = &g.s.qpos[0];
  phase(kStateFloats, [&](int t) {
    state[t] = *state_entry(in, e, t);
    if (t < 3) g.zero[t] = 0.0f;
  });
  const int n_substeps = (int)C[C_N_SUBSTEPS];
  for (int k = 0; k < n_substeps; ++k) substep(g, C, O, m);
  phase(kStateFloats, [&](int t) { *state_entry(out, e, t) = state[t]; });
}

}  // namespace serl
