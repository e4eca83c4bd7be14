// The raycast renderer (K2) as scalar fp32 code for the threads of a block
// (see render.cu, which launches it). Three stages:
//
//   joint_trig,       the env's scene row from its physics state: the joint
//   scene_lane        angles' cosines and sines by seven tasks, then FK of
//                     links 0-7, the pinch frame, the pad kinematics, the
//                     cube's rotation and the wrist camera through the
//                     attachment body. Every product in it is row by row, so
//                     lane i in {0, 1, 2} computes component i of every
//                     position and row i of every rotation, and the three
//                     lanes together write the whole row;
//   camera_invariants what every pixel of one camera shares, one task per
//                     primitive: a sphere's offset from the camera and
//                     |offset|^2 - r^2 and 1 / r; a capsule's axis, its
//                     squared length and its first sphere test's offset and
//                     |offset|^2 - r^2 (the segment point nearest the
//                     camera); a box's slab bounds -h - o.R and h - o.R;
//   render_pixel      one pixel from the scene row and the invariants.
//
// The scene and the pixels follow `build_scene`, `camera_poses` and
// `render_scene_plain` in serl_tpu_torch/envs/rendering.py, which follow
// serl_tpu/envs/rendering.py op by op: the ray from the (gx, gy) grid, the
// sky gradient, then the floor, the 2 spheres, the 6 capsules (two
// fixed-point refinements each) and the 4 oriented boxes in that order, each
// merged with a strict < so the first of equal hits wins; Lambert shading;
// clip to [0, 1], times 255, truncated to uint8. A hoisted invariant is the
// same expression on the same inputs as in the plain version, a reciprocal
// is the correctly rounded one (`rcp`) and the floor's checker parity is
// exact (`even`), so built without contracted multiply-adds (g++
// -ffp-contract=off) the per-pixel code gives the plain version's bits from
// the same scene row (tests/k2_host.cpp). The scene row itself rounds where
// the card's sinf/cosf and the order of its products round, within 2e-6 of
// the plain one (tests/test_torch_render.py).
//
// The constant row (C_COUNT floats, rendering.py::kernel_constants) and the
// env's state are the only inputs besides the pixel grid. The literals are
// the ones the JAX code writes as literals (1e9, 1e-4, 1e-6, 1e-9, 0.5,
// 0.55, 0.75, 2, 255).
//
// Nothing here is CUDA-specific beyond SERL_FN and `rcp`, so the same code
// also compiles as host C++ (tests/k2_host.cpp: the CPU tests run it, and a
// build with a counting float type gives K2's operations per env, per
// camera and per pixel).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SERL_FN __device__ __forceinline__
#else
#define SERL_FN inline
#endif

namespace serl_render {

#ifdef __CUDACC__
SERL_FN float rcp(float x) { return __frcp_rn(x); }  // 1 / x, correctly rounded
#else
SERL_FN float rcp(float x) { return 1.0f / x; }
#endif

// scene row layout (rendering.py: CAM/SPH/CAP/BOX_FLOATS)
enum : int {
  CAM_FLOATS = 12,  // position 3, world<-camera rotation 9 (row-major)
  SPH_FLOATS = 7,   // centre 3, radius, colour 3
  CAP_FLOATS = 10,  // a 3, b 3, radius, colour 3
  BOX_FLOATS = 18,  // centre 3, world<-box rotation 9 (row-major), half extents 3, colour 3
  N_SPH = 2,
  N_CAP = 6,
  N_BOX = 4,
  SPH0 = 2 * CAM_FLOATS,
  CAP0 = SPH0 + N_SPH * SPH_FLOATS,
  BOX0 = CAP0 + N_CAP * CAP_FLOATS,
  SCENE_FLOATS = BOX0 + N_BOX * BOX_FLOATS,
};

// render constants (rendering.py::RENDER_CONSTANTS), from C_RENDER on
enum : int {
  K_LIGHT = 0,       // light direction 3
  K_PLANE_LIT = 3,   // the floor's Lambert factor
  K_SKY_BOT = 4,     // sky colour at the bottom 3
  K_SKY_SPAN = 7,    // top minus bottom 3
  K_FLOOR_DARK = 10, // checker colours 3 + 3
  K_FLOOR_LIGHT = 13,
  K_COUNT = 16,
};

// constant row layout (rendering.py::_kernel_constant_table, in this order)
enum : int {
  C_BODY_POS = 0,                 // (8, 3) link frames in their parents
  C_BODY_RMAT = C_BODY_POS + 24,  // (8, 3, 3)
  C_PINCH_POS = C_BODY_RMAT + 72, // pinch site in link 7
  C_PINCH_RMAT = C_PINCH_POS + 3,
  C_Y_POLY = C_PINCH_RMAT + 9,    // pad y(theta), z(theta): cubics, highest power first
  C_Z_POLY = C_Y_POLY + 4,
  C_PAD_HALF_Y = C_Z_POLY + 4,
  C_PAD_BOX_DZ = C_PAD_HALF_Y + 1,  // 2
  C_WRIST_END = C_PAD_BOX_DZ + 2,   // the last capsule ends at pinch - Rp wrist_end
  C_HAND = C_WRIST_END + 3,         // the hand box at pinch - Rp hand
  C_ATT_R = C_HAND + 3,             // attachment body in link 7
  C_ATT_POS = C_ATT_R + 9,
  C_WRIST_R = C_ATT_POS + 3,        // wrist camera in the attachment body
  C_WRIST_POS = C_WRIST_R + 9,
  C_FRONT_POS = C_WRIST_POS + 3,    // the fixed front camera
  C_FRONT_R = C_FRONT_POS + 3,
  C_SPH_R = C_FRONT_R + 9,          // 2
  C_SPH_COL = C_SPH_R + 2,          // (2, 3)
  C_CAP_R = C_SPH_COL + 6,          // 6
  C_CAP_COL = C_CAP_R + 6,          // (6, 3)
  C_BOX_H = C_CAP_COL + 18,         // (4, 3)
  C_BOX_COL = C_BOX_H + 12,         // (4, 3)
  C_RENDER = C_BOX_COL + 12,        // K_COUNT
  C_COUNT = C_RENDER + K_COUNT,
};

// per-camera invariants layout
enum : int {
  INV_SPH_FLOATS = 5,  // o - c 3, |o - c|^2 - r^2, 1 / max(r, 1e-9)
  INV_CAP_FLOATS = 8,  // b - a 3, max(|b - a|^2, 1e-9), o - c0 3, |o - c0|^2 - r^2
  INV_BOX_FLOATS = 6,  // -h - o.R 3, h - o.R 3 (o relative to the centre)
  INV_SPH0 = 0,
  INV_CAP0 = INV_SPH0 + N_SPH * INV_SPH_FLOATS,
  INV_BOX0 = INV_CAP0 + N_CAP * INV_CAP_FLOATS,
  INV_FLOATS = INV_BOX0 + N_BOX * INV_BOX_FLOATS,
  INV_TASKS = N_SPH + N_CAP + N_BOX,
};

SERL_FN float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// r . v for a row r and a vector v
SERL_FN float row_dot(const float* r, const float* v) { return r[0] * v[0] + r[1] * v[1] + r[2] * v[2]; }

// out = r M for a row r and a row-major 3x3 M
SERL_FN void row_times(const float* r, const float* M, float* out) {
  for (int j = 0; j < 3; ++j) out[j] = r[0] * M[j] + r[1] * M[3 + j] + r[2] * M[6 + j];
}

// Horner's rule, highest power first, from 0 (gripper.polyval)
SERL_FN float polyval4(const float* c, float x) {
  float y = 0.0f;
  for (int k = 0; k < 4; ++k) y = y * x + c[k];
  return y;
}

// ---------------------------------------------------------------- scene

// Task k in [0, 7): the cosine and sine of joint k's angle, into trig[k]
// and trig[7 + k]
SERL_FN void joint_trig(int k, const float* qpos, float* trig) {
  trig[k] = cosf(qpos[k]);
  trig[7 + k] = sinf(qpos[k]);
}

// Lane i's part of the env's scene row: component i of every position, row
// i of every rotation, colour channel i, and (lane 0) the radii. trig holds
// the joint angles' cosines and sines (joint_trig); theta, cube_pos (3) and
// cube_quat (4, w x y z) are the env's state; C the constant row.
SERL_FN void scene_lane(int i, const float* trig, float theta, const float* cube_pos,
                        const float* cube_quat, const float* C, float* row) {
  // FK: p[k] is component i of link k's origin, r row i of its rotation
  float p[8];
  float r[3] = {C[C_BODY_RMAT + 3 * i], C[C_BODY_RMAT + 3 * i + 1], C[C_BODY_RMAT + 3 * i + 2]};
  p[0] = C[C_BODY_POS + i];
  for (int k = 1; k < 8; ++k) {
    p[k] = p[k - 1] + row_dot(r, C + C_BODY_POS + 3 * k);
    float f[3];
    row_times(r, C + C_BODY_RMAT + 9 * k, f);
    const float c = trig[k - 1], s = trig[6 + k];
    r[0] = f[0] * c + f[1] * s;
    r[1] = f[0] * -s + f[1] * c;
    r[2] = f[2];
  }
  // pinch frame; rp is row i of its rotation
  const float pinch = p[7] + row_dot(r, C + C_PINCH_POS);
  float rp[3];
  row_times(r, C + C_PINCH_RMAT, rp);

  // cameras: front fixed, wrist through the attachment body on link 7
  float att[3], wr[3];
  row_times(r, C + C_ATT_R, att);
  const float att_p = p[7] + row_dot(r, C + C_ATT_POS);
  row_times(att, C + C_WRIST_R, wr);
  row[i] = C[C_FRONT_POS + i];
  row[CAM_FLOATS + i] = att_p + row_dot(att, C + C_WRIST_POS);
  for (int j = 0; j < 3; ++j) {
    row[3 + 3 * i + j] = C[C_FRONT_R + 3 * i + j];
    row[CAM_FLOATS + 3 + 3 * i + j] = wr[j];
  }

  // spheres at links 3 and 5
  for (int s = 0; s < N_SPH; ++s) {
    float* sp = row + SPH0 + s * SPH_FLOATS;
    sp[i] = p[s == 0 ? 3 : 5];
    if (i == 0) sp[3] = C[C_SPH_R + s];
    sp[4 + i] = C[C_SPH_COL + 3 * s + i];
  }

  // capsules between joint origins, the last to the wrist end
  const float ends[N_CAP + 1] = {0.0f, p[1], p[3], p[4], p[5], p[7],
                                 pinch - row_dot(rp, C + C_WRIST_END)};
  for (int c = 0; c < N_CAP; ++c) {
    float* cap = row + CAP0 + c * CAP_FLOATS;
    cap[i] = ends[c];
    cap[3 + i] = ends[c + 1];
    if (i == 0) cap[6] = C[C_CAP_R + c];
    cap[7 + i] = C[C_CAP_COL + 3 * c + i];
  }

  // boxes: the cube, the hand, the right and left finger pads
  const float y_face = polyval4(C + C_Y_POLY, theta) - C[C_PAD_HALF_Y];
  const float z = polyval4(C + C_Z_POLY, theta);
  float pad[4];  // component i of the four pad points (gripper.pad_kinematics)
  for (int k = 0; k < 4; ++k) {
    const float pt[3] = {0.0f, k < 2 ? y_face : -y_face, z + C[C_PAD_BOX_DZ + (k & 1)]};
    pad[k] = pinch + (pt[0] * rp[0] + pt[1] * rp[1] + pt[2] * rp[2]);
  }
  const float w = cube_quat[0], x = cube_quat[1], y = cube_quat[2], zq = cube_quat[3];
  float rc[3];  // row i of quat_to_mat(cube_quat)
  if (i == 0) {
    rc[0] = 1.0f - 2.0f * (y * y + zq * zq);
    rc[1] = 2.0f * (x * y - w * zq);
    rc[2] = 2.0f * (x * zq + w * y);
  } else if (i == 1) {
    rc[0] = 2.0f * (x * y + w * zq);
    rc[1] = 1.0f - 2.0f * (x * x + zq * zq);
    rc[2] = 2.0f * (y * zq - w * x);
  } else {
    rc[0] = 2.0f * (x * zq - w * y);
    rc[1] = 2.0f * (y * zq + w * x);
    rc[2] = 1.0f - 2.0f * (x * x + y * y);
  }
  const float centre[N_BOX] = {cube_pos[i], pinch - row_dot(rp, C + C_HAND),
                               0.5f * (pad[0] + pad[1]), 0.5f * (pad[2] + pad[3])};
  for (int b = 0; b < N_BOX; ++b) {
    float* bx = row + BOX0 + b * BOX_FLOATS;
    bx[i] = centre[b];
    for (int j = 0; j < 3; ++j) bx[3 + 3 * i + j] = b == 0 ? rc[j] : rp[j];
    bx[12 + i] = C[C_BOX_H + 3 * b + i];
    bx[15 + i] = C[C_BOX_COL + 3 * b + i];
  }
}

// ---------------------------------------------------------------- camera

SERL_FN float segment_param(float px, float py, float pz, const float* a, float abx, float aby,
                            float abz, float ab2) {
  return clip01(((px - a[0]) * abx + (py - a[1]) * aby + (pz - a[2]) * abz) / ab2);
}

// Task `task` (a primitive: spheres, capsules, boxes) of camera `cam`'s
// invariants, from the env's scene row.
SERL_FN void camera_invariants(int task, const float* scene, int cam, float* inv) {
  const float* o = scene + cam * CAM_FLOATS;
  if (task < N_SPH) {
    const float* sp = scene + SPH0 + task * SPH_FLOATS;
    float* v = inv + INV_SPH0 + task * INV_SPH_FLOATS;
    const float bx = o[0] - sp[0], by = o[1] - sp[1], bz = o[2] - sp[2];
    v[0] = bx;
    v[1] = by;
    v[2] = bz;
    v[3] = bx * bx + by * by + bz * bz - sp[3] * sp[3];
    v[4] = rcp(fmaxf(sp[3], 1e-9f));
  } else if (task < N_SPH + N_CAP) {
    const int c = task - N_SPH;
    const float* a = scene + CAP0 + c * CAP_FLOATS;
    const float* b = a + 3;
    const float r = a[6];
    float* v = inv + INV_CAP0 + c * INV_CAP_FLOATS;
    const float abx = b[0] - a[0], aby = b[1] - a[1], abz = b[2] - a[2];
    const float ab2 = fmaxf(abx * abx + aby * aby + abz * abz, 1e-9f);
    const float s = segment_param(o[0], o[1], o[2], a, abx, aby, abz, ab2);
    const float bx = o[0] - (a[0] + s * abx), by = o[1] - (a[1] + s * aby),
                bz = o[2] - (a[2] + s * abz);
    v[0] = abx;
    v[1] = aby;
    v[2] = abz;
    v[3] = ab2;
    v[4] = bx;
    v[5] = by;
    v[6] = bz;
    v[7] = bx * bx + by * by + bz * bz - r * r;
  } else {
    const int k = task - N_SPH - N_CAP;
    const float* c = scene + BOX0 + k * BOX_FLOATS;
    const float* R = c + 3;
    const float* h = c + 12;
    float* v = inv + INV_BOX0 + k * INV_BOX_FLOATS;
    const float wx = o[0] - c[0], wy = o[1] - c[1], wz = o[2] - c[2];
    for (int j = 0; j < 3; ++j) {
      const float ol = R[j] * wx + R[3 + j] * wy + R[6 + j] * wz;
      v[j] = -h[j] - ol;
      v[3 + j] = h[j] - ol;
    }
  }
}

// ---------------------------------------------------------------- pixel

struct Hit {
  float t, r, g, b;
};

// running closest hit: strict < keeps the first of equal hits
SERL_FN void merge(Hit& best, float t, float r, float g, float b) {
  if (t < best.t) {
    best.t = t;
    best.r = r;
    best.g = g;
    best.b = b;
  }
}

// Lambert with headlight ambient: colour * (0.55 + 0.55 * clip(n . L, 0, 1))
SERL_FN void shade_merge(Hit& best, float t, const float* col, float nx, float ny, float nz,
                         const float* K) {
  const float diff = clip01(nx * K[K_LIGHT] + ny * K[K_LIGHT + 1] + nz * K[K_LIGHT + 2]);
  const float lit = 0.55f + 0.55f * diff;
  merge(best, t, col[0] * lit, col[1] * lit, col[2] * lit);
}

// ray-sphere hit distance (1e9 for a miss) from the origin's offset
// (bx, by, bz) = o - c and cc = |o - c|^2 - r^2
SERL_FN float sphere_hit(float bx, float by, float bz, float cc, const float* d) {
  const float b = bx * d[0] + by * d[1] + bz * d[2];
  const float disc = b * b - cc;
  const float t = -b - sqrtf(fmaxf(disc, 0.0f));
  return (disc > 0.0f && t > 1e-4f) ? t : 1e9f;
}

// the same for a sphere at (cx, cy, cz) of radius r
SERL_FN float sphere_t(const float* o, const float* d, float cx, float cy, float cz, float r) {
  const float bx = o[0] - cx, by = o[1] - cy, bz = o[2] - cz;
  return sphere_hit(bx, by, bz, bx * bx + by * by + bz * bz - r * r, d);
}

// swept sphere: project the hit estimate onto the segment, sphere-test there;
// the first test is at the segment point nearest the camera (invariants v)
SERL_FN void capsule(Hit& best, const float* o, const float* d, const float* cap, const float* v,
                     const float* K) {
  const float* a = cap;
  const float r = cap[6];
  const float abx = v[0], aby = v[1], abz = v[2], ab2 = v[3];
  float t = sphere_hit(v[4], v[5], v[6], v[7], d);
  float s = 0.0f;
  for (int it = 0; it < 2; ++it) {
    if (it > 0) t = sphere_t(o, d, a[0] + s * abx, a[1] + s * aby, a[2] + s * abz, r);
    const float ts = t >= 1e9f ? 0.0f : t;
    s = segment_param(o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2], a, abx, aby, abz,
                      ab2);
  }
  const float cx = a[0] + s * abx, cy = a[1] + s * aby, cz = a[2] + s * abz;
  t = sphere_t(o, d, cx, cy, cz, r);
  const float ts = t >= 1e9f ? 0.0f : t;
  const float nx = o[0] + ts * d[0] - cx;
  const float ny = o[1] + ts * d[1] - cy;
  const float nz = o[2] + ts * d[2] - cz;
  const float inv = rcp(fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-9f));
  shade_merge(best, t, cap + 7, nx * inv, ny * inv, nz * inv, K);
}

// oriented-box slab test from the slab bounds v; the normal is
// -sign(d . R[:, axis]) R[:, axis] of the entry axis (largest slab entry,
// ties to the first); sign(0) = 0
SERL_FN void box(Hit& best, const float* d, const float* bx, const float* v, const float* K) {
  const float* R = bx + 3;
  float tmin = -1e9f, tmax = 1e9f;
  float entry[3], dl[3];
  for (int k = 0; k < 3; ++k) {
    dl[k] = R[k] * d[0] + R[3 + k] * d[1] + R[6 + k] * d[2];
    const float den = fabsf(dl[k]) < 1e-9f ? (dl[k] >= 0.0f ? 1e-9f : -1e-9f) : dl[k];
    const float inv = rcp(den);
    const float t1 = v[k] * inv;
    const float t2 = v[3 + k] * inv;
    const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
    tmin = fmaxf(tmin, lo);
    tmax = fminf(tmax, hi);
    entry[k] = lo;
  }
  const bool hit_ok = tmax > fmaxf(tmin, 1e-4f);
  const float t = (hit_ok && tmin > 1e-4f) ? tmin : 1e9f;
  const int axis = (entry[0] >= entry[1] && entry[0] >= entry[2]) ? 0
                   : (entry[1] >= entry[2])                        ? 1
                                                                   : 2;
  const float sgn = dl[axis] > 0.0f ? -1.0f : (dl[axis] < 0.0f ? 1.0f : 0.0f);
  shade_merge(best, t, bx + 15, 0.0f + R[axis] * sgn, 0.0f + R[3 + axis] * sgn,
              0.0f + R[6 + axis] * sgn, K);
}

// fmod(k, 2) == 0 for an integer-valued k, exactly: 0.5 k, its floor and
// 2 floor(0.5 k) are exact, and every float of magnitude 2^24 or more is even
SERL_FN bool even(float k) { return k - 2.0f * floorf(0.5f * k) == 0.0f; }

// The uint8 RGB of one pixel: `scene` is the env's row, `inv` the camera's
// invariants, `cam` 0 (front) or 1 (wrist), K the render constants, (gx,
// gy) the pixel's image-plane coordinates.
SERL_FN void render_pixel(const float* scene, const float* inv, int cam, const float* K, float gx,
                          float gy, unsigned char* rgb) {
  const float* o = scene + cam * CAM_FLOATS;  // position, then rotation
  const float* R = o + 3;
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = R[3 * i] * gx + R[3 * i + 1] * gy - R[3 * i + 2];
  const float len_inv = rcp(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]));
  for (int i = 0; i < 3; ++i) d[i] = d[i] * len_inv;

  // sky background, a gradient on the ray's elevation
  const float tsky = clip01(d[2] * 0.5f + 0.5f);
  Hit best;
  best.t = 1e9f;
  best.r = K[K_SKY_BOT] + tsky * K[K_SKY_SPAN];
  best.g = K[K_SKY_BOT + 1] + tsky * K[K_SKY_SPAN + 1];
  best.b = K[K_SKY_BOT + 2] + tsky * K[K_SKY_SPAN + 2];

  // checker floor at z = 0, ~0.75 m squares; its normal is +z
  {
    const float t = d[2] < -1e-6f ? -o[2] / d[2] : 1e9f;
    const float px = o[0] + t * d[0];
    const float py = o[1] + t * d[1];
    const float k = floorf(px / 0.75f) + floorf(py / 0.75f);
    const float* col = even(k) ? K + K_FLOOR_DARK : K + K_FLOOR_LIGHT;
    const float lit = K[K_PLANE_LIT];
    merge(best, t, col[0] * lit, col[1] * lit, col[2] * lit);
  }
  for (int i = 0; i < N_SPH; ++i) {
    const float* sp = scene + SPH0 + i * SPH_FLOATS;
    const float* v = inv + INV_SPH0 + i * INV_SPH_FLOATS;
    const float t = sphere_hit(v[0], v[1], v[2], v[3], d);
    shade_merge(best, t, sp + 4, (v[0] + t * d[0]) * v[4], (v[1] + t * d[1]) * v[4],
                (v[2] + t * d[2]) * v[4], K);
  }
  for (int i = 0; i < N_CAP; ++i)
    capsule(best, o, d, scene + CAP0 + i * CAP_FLOATS, inv + INV_CAP0 + i * INV_CAP_FLOATS, K);
  for (int i = 0; i < N_BOX; ++i)
    box(best, d, scene + BOX0 + i * BOX_FLOATS, inv + INV_BOX0 + i * INV_BOX_FLOATS, K);

  rgb[0] = (unsigned char)(int)(clip01(best.r) * 255.0f);
  rgb[1] = (unsigned char)(int)(clip01(best.g) * 255.0f);
  rgb[2] = (unsigned char)(int)(clip01(best.b) * 255.0f);
}

}  // namespace serl_render
