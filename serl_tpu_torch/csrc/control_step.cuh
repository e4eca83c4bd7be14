// One env's 20 ms control step of the Panda + gripper + cube physics, as
// scalar fp32 code that one CUDA thread runs (see control_step.cu).
//
// It is the per-thread form of `control_step_plain` in
// serl_tpu_torch/envs/physics/engine.py and follows that file's arithmetic
// step by step: FK, CRBA mass matrix, RNEA bias forces, floor and pad penalty
// contacts, operational-space torques with the det-threshold damping, an
// implicit-damping 7x7 SPD solve, the reduced gripper DOF and the free-body
// cube. Every model and contact constant comes from the float buffer `C`
// (offsets below), which the wrapper packs from the Python constants; the
// only literals here are the numerical guards that math3d.py and engine.py
// also write as literals (1e-12, 1e-9, 1e-8).
//
// Nothing in this header is CUDA-specific beyond SERL_FN, so the same
// arithmetic also compiles as host C++.
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

// One env's state, held by its thread for the whole control step.
struct State {
  float qpos[7], qvel[7], theta, dtheta, grip_ctrl;
  float mocap_pos[3], mocap_quat[4];
  float cube_pos[3], cube_quat[4], cube_linvel[3], cube_angvel[3];
};

// ---------------------------------------------------------------- helpers

SERL_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

SERL_FN void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
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

// out = A B for row-major 3x3 matrices
SERL_FN void matmul3(const float* A, const float* B, float* out) {
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) {
    SERL_UNROLL
    for (int c = 0; c < 3; ++c)
      out[3 * r + c] = A[3 * r] * B[c] + A[3 * r + 1] * B[3 + c] + A[3 * r + 2] * B[6 + c];
  }
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
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
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
  const float scale = sin_half < 1e-8f ? 2.0f : angle / fmaxf(sin_half, 1e-12f);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) out[k] = v[k] * scale;
}

// q' = exp(dt/2 * omega) * q (math3d.quat_integrate)
SERL_FN void quat_integrate(float* q, const float* omega, float dt) {
  const float angle = norm3(omega);
  const float inv = fmaxf(angle, 1e-12f);
  const float half = (angle * dt) * 0.5f;
  const float s = sinf(half);
  const float dq[4] = {cosf(half), omega[0] / inv * s, omega[1] / inv * s, omega[2] / inv * s};
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

// Cholesky with the pivot clamp (linalg_small.chol_unrolled); L lower.
template <int N>
SERL_FN void chol(const float (*A)[N], float (*L)[N], float pivot_eps) {
  SERL_UNROLL
  for (int i = 0; i < N; ++i) {
    SERL_UNROLL
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
      SERL_UNROLL
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(fmaxf(s, pivot_eps)) : s / L[j][j];
    }
  }
}

// x = (L L^T)^-1 b
template <int N>
SERL_FN void chol_solve(const float (*L)[N], const float* b, float* x) {
  float y[N];
  SERL_UNROLL
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    SERL_UNROLL
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  SERL_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    SERL_UNROLL
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// 3x3 solve via the adjugate (linalg_small.solve3); A row-major
SERL_FN void solve3(const float* A, const float* b, float* x) {
  float c0[3], c1[3], c2[3];
  cross3(A + 3, A + 6, c0);
  const float det = dot3(A, c0);
  cross3(A + 6, A, c1);
  cross3(A, A + 3, c2);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) x[k] = (c0[k] * b[0] + c1[k] * b[1] + c2[k] * b[2]) / det;
}

// Regularized Coulomb friction capped at the velocity-matching impulse
// (engine._friction): adds the friction force for tangential velocity vt.
SERL_FN void friction(float fn_mag, const float* vt, float mu, const float* C, float* f) {
  const float vt_norm = norm3(vt);
  const float ft_mag = fminf(mu * fn_mag * tanhf(vt_norm / C[C_V_EPS]),
                             C[C_IMPULSE_CAP] * vt_norm / C[C_DT]);
  const float d = fmaxf(vt_norm, 1e-9f);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) f[k] = f[k] + -ft_mag * vt[k] / d;
}

// Spatial inertia (6x6, [w; v] at the world origin) of moving link l (1..7)
SERL_FN void link_inertia(int l, const float* p, const float* R, const float* C, float (*I6)[6]) {
  float com[3], Ii[9], tmp[9], Iw[9];
  matvec3(R, C + C_BODY_IPOS + 3 * l, com);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) com[k] = p[k] + com[k];
  matmul3(R, C + C_BODY_INERTIA + 9 * l, tmp);
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) {
    SERL_UNROLL
    for (int c = 0; c < 3; ++c)  // tmp @ R^T
      Iw[3 * r + c] = tmp[3 * r] * R[3 * c] + tmp[3 * r + 1] * R[3 * c + 1] + tmp[3 * r + 2] * R[3 * c + 2];
  }
  const float m = C[C_BODY_MASS + l];
  const float S[9] = {0.0f, -com[2], com[1], com[2], 0.0f, -com[0], -com[1], com[0], 0.0f};
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) {
    SERL_UNROLL
    for (int c = 0; c < 3; ++c) {
      const float sst = S[3 * r] * S[3 * c] + S[3 * r + 1] * S[3 * c + 1] + S[3 * r + 2] * S[3 * c + 2];
      Ii[3 * r + c] = Iw[3 * r + c] + m * sst;
      I6[r][c] = Ii[3 * r + c];
      I6[r][3 + c] = m * S[3 * r + c];
      I6[3 + r][c] = m * S[3 * c + r];
      I6[3 + r][3 + c] = r == c ? m : 0.0f;
    }
  }
}

SERL_FN void matvec6(const float (*A)[6], const float* v, float* out) {
  SERL_UNROLL
  for (int r = 0; r < 6; ++r) {
    float s = 0.0f;
    SERL_UNROLL
    for (int c = 0; c < 6; ++c) s = s + A[r][c] * v[c];
    out[r] = s;
  }
}

// ---------------------------------------------------------------- substep

SERL_FN void substep(State& s, const float* __restrict__ C) {
  const float dt = C[C_DT];

  // ---- forward kinematics ----
  float p[8][3], R[8][9], ax[7][3];
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) p[0][k] = C[C_BODY_POS + k];
  SERL_UNROLL
  for (int k = 0; k < 9; ++k) R[0][k] = C[C_BODY_RMAT + k];
  SERL_UNROLL
  for (int i = 1; i < 8; ++i) {
    float off[3], Rf[9];
    matvec3(R[i - 1], C + C_BODY_POS + 3 * i, off);
    SERL_UNROLL
    for (int k = 0; k < 3; ++k) p[i][k] = p[i - 1][k] + off[k];
    matmul3(R[i - 1], C + C_BODY_RMAT + 9 * i, Rf);
    const float cq = cosf(s.qpos[i - 1]), sq = sinf(s.qpos[i - 1]);
    SERL_UNROLL
    for (int r = 0; r < 3; ++r) {  // Rf @ Rz(q)
      R[i][3 * r] = Rf[3 * r] * cq + Rf[3 * r + 1] * sq;
      R[i][3 * r + 1] = Rf[3 * r] * -sq + Rf[3 * r + 1] * cq;
      R[i][3 * r + 2] = Rf[3 * r + 2];
      ax[i - 1][r] = R[i][3 * r + 2];
    }
  }
  float pinch[3], PR[9];
  matvec3(R[7], C + C_PINCH_POS, pinch);
  SERL_UNROLL
  for (int k = 0; k < 3; ++k) pinch[k] = p[7][k] + pinch[k];
  matmul3(R[7], C + C_PINCH_RMAT, PR);

  // pinch-site Jacobian columns [a_i; a_i x (pinch - o_i)] and motion
  // subspaces S_i = [a_i; o_i x a_i]
  float Jv[7][3], S[7][6];
  SERL_UNROLL
  for (int i = 0; i < 7; ++i) {
    const float d[3] = {pinch[0] - p[i + 1][0], pinch[1] - p[i + 1][1], pinch[2] - p[i + 1][2]};
    cross3(ax[i], d, Jv[i]);
    SERL_UNROLL
    for (int k = 0; k < 3; ++k) S[i][k] = ax[i][k];
    cross3(p[i + 1], ax[i], &S[i][3]);
  }
  float pinch_v[3], pinch_w[3];
  SERL_UNROLL
  for (int r = 0; r < 3; ++r) {
    float sv = 0.0f, sw = 0.0f;
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      sw = sw + ax[i][r] * s.qvel[i];
      sv = sv + Jv[i][r] * s.qvel[i];
    }
    pinch_v[r] = sv;
    pinch_w[r] = sw;
  }

  // ---- RNEA forward pass: link velocities and accelerations (qacc = 0) ----
  float vs[7][6], as[7][6];
  {
    float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float a[6] = {0.0f, 0.0f, 0.0f, -C[C_GRAVITY], -C[C_GRAVITY + 1], -C[C_GRAVITY + 2]};
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      float vJ[6];
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) {
        vJ[k] = S[i][k] * s.qvel[i];
        v[k] = v[k] + vJ[k];
      }
      // crm(v) vJ = [w x vJ_w; vo x vJ_w + w x vJ_v]
      float t0[3], t1[3], t2[3];
      cross3(v, vJ, t0);
      cross3(v + 3, vJ, t1);
      cross3(v, vJ + 3, t2);
      SERL_UNROLL
      for (int k = 0; k < 3; ++k) {
        a[k] = a[k] + t0[k];
        a[3 + k] = a[3 + k] + (t1[k] + t2[k]);
      }
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) {
        vs[i][k] = v[k];
        as[i][k] = a[k];
      }
    }
  }

  // ---- backward pass: CRBA composite inertias and RNEA forces ----
  float F[7][6], bias[7];
  {
    float Ic[6][6], fC[6];
    SERL_UNROLL
    for (int r = 0; r < 6; ++r) {
      fC[r] = 0.0f;
      SERL_UNROLL
      for (int c = 0; c < 6; ++c) Ic[r][c] = 0.0f;
    }
    SERL_UNROLL
    for (int i = 6; i >= 0; --i) {
      float I6[6][6];
      link_inertia(i + 1, p[i + 1], R[i + 1], C, I6);
      SERL_UNROLL
      for (int r = 0; r < 6; ++r) {
        SERL_UNROLL
        for (int c = 0; c < 6; ++c) Ic[r][c] = Ic[r][c] + I6[r][c];
      }
      matvec6(Ic, S[i], F[i]);
      // f_i = I_i a_i + crf(v_i) I_i v_i, crf(v) [n; f] = [w x n + vo x f; w x f]
      float Ia[6], h[6], t0[3], t1[3], t2[3];
      matvec6(I6, as[i], Ia);
      matvec6(I6, vs[i], h);
      cross3(vs[i], h, t0);
      cross3(vs[i] + 3, h + 3, t1);
      cross3(vs[i], h + 3, t2);
      float proj = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 3; ++k) {
        fC[k] = fC[k] + (Ia[k] + (t0[k] + t1[k]));
        fC[3 + k] = fC[3 + k] + (Ia[3 + k] + t2[k]);
      }
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) proj = proj + S[i][k] * fC[k];
      bias[i] = proj;
    }
  }
  float M[7][7];
  SERL_UNROLL
  for (int i = 0; i < 7; ++i) {
    SERL_UNROLL
    for (int j = i; j < 7; ++j) {
      float m = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) m = m + S[i][k] * F[j][k];
      M[i][j] = m;
      M[j][i] = m;
    }
    M[i][i] = M[i][i] + C[C_ARMATURE + i];
  }

  // ---- cube frame ----
  float Rc[9];
  quat_to_mat(s.cube_quat, Rc);

  // ---- floor contact: 8 corner penalty contacts ----
  float f_cube[3] = {0.0f, 0.0f, 0.0f}, tau_cube[3] = {0.0f, 0.0f, 0.0f};
  SERL_UNROLL
  for (int k = 0; k < 8; ++k) {
    float cw[3], r[3], v[3], wr[3];
    matvec3(Rc, C + C_CORNERS + 3 * k, cw);
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
      f_cube[d] = f_cube[d] + f[d];
      tau_cube[d] = tau_cube[d] + t[d];
    }
  }

  // ---- pad contacts: 4 pad points, plane vs box along the closing axis ----
  float f_arm[3] = {0.0f, 0.0f, 0.0f}, tau_arm[3] = {0.0f, 0.0f, 0.0f};
  float f_cube_p[3] = {0.0f, 0.0f, 0.0f}, tau_cube_p[3] = {0.0f, 0.0f, 0.0f};
  float tau_theta = 0.0f;
  {
    const float y = polyval<4>(C + C_Y_POLY, s.theta);
    const float z = polyval<4>(C + C_Z_POLY, s.theta);
    const float dy = polyval<3>(C + C_DY_POLY, s.theta);
    const float dz = polyval<3>(C + C_DZ_POLY, s.theta);
    const float y_face = y - C[C_PAD_HALF_Y];
    SERL_UNROLL
    for (int k = 0; k < 4; ++k) {
      const float side = k < 2 ? 1.0f : -1.0f;  // right (+y), left (-y)
      const float local[3] = {0.0f, side * y_face, z + C[C_PAD_BOX_DZ + (k & 1)]};
      const float normal[3] = {0.0f, -side, 0.0f};
      const float jac[3] = {0.0f, side * dy, dz};
      float pw[3], out_w[3], dpt[3], u[3], xi[3], ac[3];
      matvec3(PR, local, pw);
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) pw[d] = pinch[d] + pw[d];
      matvec3(PR, normal, out_w);
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) out_w[d] = -out_w[d];
      matvec3(PR, jac, dpt);
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) u[d] = pw[d] - s.cube_pos[d];
      matTvec3(Rc, u, xi);
      bool lateral_ok = true;
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) lateral_ok = lateral_ok && fabsf(xi[d]) < C[C_LATERAL_LIMIT + d];
      matTvec3(Rc, out_w, ac);
      const float support = fabsf(ac[0]) * C[C_CUBE_HALF] + fabsf(ac[1]) * C[C_CUBE_HALF + 1] +
                            fabsf(ac[2]) * C[C_CUBE_HALF + 2];
      const float d_axis = dot3(u, out_w);
      const float depth = support - d_axis;
      const bool active = lateral_ok && depth > 0.0f && d_axis > 0.0f;

      float r_p[3], wc[3], wp[3], v_rel[3];
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) r_p[d] = pw[d] - pinch[d];
      cross3(s.cube_angvel, u, wc);
      cross3(pinch_w, r_p, wp);
      SERL_UNROLL
      for (int d = 0; d < 3; ++d) {
        const float v_pad = pinch_v[d] + wp[d] + dpt[d] * s.dtheta;
        const float v_cube = s.cube_linvel[d] + wc[d];
        v_rel[d] = v_pad - v_cube;
      }
      const float vn = dot3(v_rel, out_w);
      float fn = active ? C[C_KN_PAD] * depth - C[C_KD_PAD] * vn : 0.0f;
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
        f_cube_p[d] = f_cube_p[d] + nf[d];
        tau_cube_p[d] = tau_cube_p[d] + tc[d];
        f_arm[d] = f_arm[d] + f[d];
        tau_arm[d] = tau_arm[d] + ta[d];
        tau_theta = tau_theta + f[d] * dpt[d];
      }
    }
  }

  // ---- operational-space controller ----
  float tau[7];
  {
    float ddx_dw[6];
    SERL_UNROLL
    for (int k = 0; k < 3; ++k)
      ddx_dw[k] = -C[C_KP_POS] * (pinch[k] - s.mocap_pos[k]) - C[C_KD_POS] * pinch_v[k];
    float quat[4], qc[4], q_err[4], ori_err[3];
    mat_to_quat(PR, quat);
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
    for (int k = 0; k < 3; ++k) ddx_dw[3 + k] = -C[C_KP_ORI] * ori_err[k] - C[C_KD_ORI] * pinch_w[k];

    // Jfull = [Jv; Jw] (6x7); its columns are JT[i] = [Jv_i; a_i]
    float JT[7][6];
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      SERL_UNROLL
      for (int k = 0; k < 3; ++k) {
        JT[i][k] = Jv[i][k];
        JT[i][3 + k] = ax[i][k];
      }
    }
    // X = M^-1 Jfull^T (7x6), one Cholesky solve per column
    float L7[7][7], X[7][6];
    chol<7>(M, L7, C[C_PIVOT_EPS]);
    SERL_UNROLL
    for (int c = 0; c < 6; ++c) {
      float b[7], x[7];
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) b[i] = JT[i][c];
      chol_solve<7>(L7, b, x);
      SERL_UNROLL
      for (int i = 0; i < 7; ++i) X[i][c] = x[i];
    }
    // Mx_inv = Jfull X (6x6); det-threshold Tikhonov damping; Mx = inverse
    float A[6][6], L6[6][6], Mx[6][6];
    SERL_UNROLL
    for (int r = 0; r < 6; ++r) {
      SERL_UNROLL
      for (int c = 0; c < 6; ++c) {
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 7; ++k) m = m + JT[k][r] * X[k][c];
        A[r][c] = m;
      }
    }
    chol<6>(A, L6, C[C_PIVOT_EPS]);
    float det = L6[0][0] * L6[0][0];
    SERL_UNROLL
    for (int i = 1; i < 6; ++i) det = det * (L6[i][i] * L6[i][i]);
    const float eps = fabsf(det) < C[C_DET_THRESHOLD] ? C[C_EPS_SINGULAR] : C[C_EPS_REGULAR];
    SERL_UNROLL
    for (int i = 0; i < 6; ++i) A[i][i] = A[i][i] + eps;
    chol<6>(A, L6, C[C_PIVOT_EPS]);
    SERL_UNROLL
    for (int c = 0; c < 6; ++c) {
      float e[6], x[6];
      SERL_UNROLL
      for (int i = 0; i < 6; ++i) e[i] = i == c ? 1.0f : 0.0f;
      chol_solve<6>(L6, e, x);
      SERL_UNROLL
      for (int i = 0; i < 6; ++i) Mx[i][c] = x[i];
    }
    // tau = Jfull^T (Mx ddx_dw)
    float t6[6];
    matvec6(Mx, ddx_dw, t6);
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      float m = 0.0f;
      SERL_UNROLL
      for (int k = 0; k < 6; ++k) m = m + JT[i][k] * t6[k];
      tau[i] = m;
    }
    // nullspace joint PD: tau += (I - Jfull^T Jnull^T) ddq, Jnull = X Mx
    float ddq[7], Jnull[7][6];
    SERL_UNROLL
    for (int i = 0; i < 7; ++i)
      ddq[i] = -C[C_KP_NULL] * (s.qpos[i] - C[C_Q_HOME + i]) - C[C_KD_NULL] * s.qvel[i];
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      SERL_UNROLL
      for (int c = 0; c < 6; ++c) {
        float m = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 6; ++k) m = m + X[i][k] * Mx[k][c];
        Jnull[i][c] = m;
      }
    }
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      float m = 0.0f;
      SERL_UNROLL
      for (int j = 0; j < 7; ++j) {
        float pij = 0.0f;
        SERL_UNROLL
        for (int k = 0; k < 6; ++k) pij = pij + JT[i][k] * Jnull[j][k];
        m = m + ((i == j ? 1.0f : 0.0f) - pij) * ddq[j];
      }
      tau[i] = tau[i] + m;
    }
    SERL_UNROLL
    for (int i = 0; i < 7; ++i)
      tau[i] = fminf(fmaxf(tau[i] + bias[i], C[C_TORQUE_LO + i]), C[C_TORQUE_HI + i]);
  }

  // ---- arm integration with implicit joint damping ----
  {
    float rhs[7], qacc[7], L7[7][7];
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      // contact reaction through the pinch-site Jacobian: J^T [tau_arm; f_arm]
      const float ext = ax[i][0] * tau_arm[0] + ax[i][1] * tau_arm[1] + ax[i][2] * tau_arm[2] +
                        Jv[i][0] * f_arm[0] + Jv[i][1] * f_arm[1] + Jv[i][2] * f_arm[2];
      rhs[i] = tau[i] + ext - bias[i] - C[C_JOINT_DAMPING + i] * s.qvel[i];
      M[i][i] = M[i][i] + dt * C[C_JOINT_DAMPING + i];
    }
    chol<7>(M, L7, C[C_PIVOT_EPS]);
    chol_solve<7>(L7, rhs, qacc);
    SERL_UNROLL
    for (int i = 0; i < 7; ++i) {
      const float qv = s.qvel[i] + dt * qacc[i];
      const float q = s.qpos[i] + dt * qv;
      const float clamped = fminf(fmaxf(q, C[C_JNT_LO + i]), C[C_JNT_HI + i]);
      s.qvel[i] = clamped == q ? qv : 0.0f;
      s.qpos[i] = clamped;
    }
  }

  // ---- gripper DOF: semi-implicit Euler, range clamp with velocity kill ----
  {
    float f_act = C[C_GRIP_GAIN] * s.grip_ctrl - C[C_BIAS_KP] * s.theta - C[C_BIAS_KV] * s.dtheta;
    f_act = fminf(fmaxf(f_act, C[C_F_LO]), C[C_F_HI]);
    const float f_spring = C[C_SPRING_K] * (C[C_SPRING_REF] - s.theta);
    const float acc =
        (f_act + f_spring - C[C_GRIP_DAMPING] * s.dtheta + tau_theta) / C[C_GRIP_INERTIA];
    const float dth = s.dtheta + dt * acc;
    const float th = s.theta + dt * dth;
    const float clamped = fminf(fmaxf(th, C[C_THETA_LO]), C[C_THETA_HI]);
    s.dtheta = clamped == th ? dth : 0.0f;
    s.theta = clamped;
  }

  // ---- cube free-body integration ----
  {
    const float m = C[C_CUBE_MASS];
    float linvel[3];
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) {
      const float f = f_cube[d] + f_cube_p[d] + m * C[C_GRAVITY + d];
      linvel[d] = s.cube_linvel[d] + dt * f / m;
    }
    // world-frame rotational dynamics with body-diagonal inertia
    float Iw[9], Iwv[3], gyro[3], rhs[3], dw[3];
    SERL_UNROLL
    for (int r = 0; r < 3; ++r) {
      SERL_UNROLL
      for (int c = 0; c < 3; ++c)
        Iw[3 * r + c] = Rc[3 * r] * C[C_CUBE_I_DIAG] * Rc[3 * c] +
                        Rc[3 * r + 1] * C[C_CUBE_I_DIAG + 1] * Rc[3 * c + 1] +
                        Rc[3 * r + 2] * C[C_CUBE_I_DIAG + 2] * Rc[3 * c + 2];
    }
    matvec3(Iw, s.cube_angvel, Iwv);
    cross3(s.cube_angvel, Iwv, gyro);
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) rhs[d] = (tau_cube[d] + tau_cube_p[d]) - gyro[d];
    solve3(Iw, rhs, dw);
    float angvel[3];
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) {
      angvel[d] = s.cube_angvel[d] + dt * dw[d];
      s.cube_linvel[d] = linvel[d];
      s.cube_pos[d] = s.cube_pos[d] + dt * linvel[d];
    }
    quat_integrate(s.cube_quat, angvel, dt);
    SERL_UNROLL
    for (int d = 0; d < 3; ++d) s.cube_angvel[d] = angvel[d];
  }
}

// ---------------------------------------------------------------- env step

SERL_FN void load(const Fields& f, int e, State& s) {
  for (int k = 0; k < 7; ++k) {
    s.qpos[k] = f.qpos[7 * e + k];
    s.qvel[k] = f.qvel[7 * e + k];
  }
  s.theta = f.theta[e];
  s.dtheta = f.dtheta[e];
  s.grip_ctrl = f.grip_ctrl[e];
  for (int k = 0; k < 3; ++k) {
    s.mocap_pos[k] = f.mocap_pos[3 * e + k];
    s.cube_pos[k] = f.cube_pos[3 * e + k];
    s.cube_linvel[k] = f.cube_linvel[3 * e + k];
    s.cube_angvel[k] = f.cube_angvel[3 * e + k];
  }
  for (int k = 0; k < 4; ++k) {
    s.mocap_quat[k] = f.mocap_quat[4 * e + k];
    s.cube_quat[k] = f.cube_quat[4 * e + k];
  }
}

SERL_FN void store(const Fields& f, int e, const State& s) {
  for (int k = 0; k < 7; ++k) {
    f.qpos[7 * e + k] = s.qpos[k];
    f.qvel[7 * e + k] = s.qvel[k];
  }
  f.theta[e] = s.theta;
  f.dtheta[e] = s.dtheta;
  f.grip_ctrl[e] = s.grip_ctrl;
  for (int k = 0; k < 3; ++k) {
    f.mocap_pos[3 * e + k] = s.mocap_pos[k];
    f.cube_pos[3 * e + k] = s.cube_pos[k];
    f.cube_linvel[3 * e + k] = s.cube_linvel[k];
    f.cube_angvel[3 * e + k] = s.cube_angvel[k];
  }
  for (int k = 0; k < 4; ++k) {
    f.mocap_quat[4 * e + k] = s.mocap_quat[k];
    f.cube_quat[4 * e + k] = s.cube_quat[k];
  }
}

// Env e: read its state from `in`, run the substeps, write it to `out`.
SERL_FN void control_step_env(const Fields& in, const Fields& out, const float* __restrict__ C,
                              int e) {
  State s;
  load(in, e, s);
  const int n_substeps = (int)C[C_N_SUBSTEPS];
  for (int k = 0; k < n_substeps; ++k) substep(s, C);
  store(out, e, s);
}

}  // namespace serl
