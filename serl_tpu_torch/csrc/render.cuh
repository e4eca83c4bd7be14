// One pixel of the raycast renderer, as scalar fp32 code that one CUDA thread
// runs (see render.cu).
//
// It is the per-pixel form of `render_scene_plain` in
// serl_tpu_torch/envs/rendering.py, which follows serl_tpu/envs/rendering.py
// op by op: the ray from the (gx, gy) grid, the sky gradient, then the floor,
// the 2 spheres, the 6 capsules (two fixed-point refinements each) and the 4
// oriented boxes in that order, each merged with a strict < so the first of
// equal hits wins; Lambert shading; clip to [0, 1], times 255, truncated to
// uint8. Every operation is written in the order of the Python code, and
// render.cu is compiled with -fmad=false so that no multiply-add is fused:
// the kernel then rounds where the plain version rounds.
//
// The scene row (SCENE_FLOATS per env, packed by rendering.py::pack_scene)
// and the constant row (K_COUNT floats, rendering.py::RENDER_CONSTANTS) are
// the only inputs besides the pixel's (gx, gy). The literals are the ones
// the JAX code writes as literals (1e9, 1e-4, 1e-6, 1e-9, 0.5, 0.55, 0.75,
// 2, 255).
//
// Nothing in this header is CUDA-specific beyond SERL_FN, so the same code
// also compiles as host C++ (tests/k2_host.cpp: the CPU tests run it, and a
// build with a counting float type gives K2's operations per pixel).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SERL_FN __device__ __forceinline__
#else
#define SERL_FN inline
#endif

namespace serl_render {

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

// constant row layout (rendering.py::RENDER_CONSTANTS)
enum : int {
  K_LIGHT = 0,       // light direction 3
  K_PLANE_LIT = 3,   // the floor's Lambert factor
  K_SKY_BOT = 4,     // sky colour at the bottom 3
  K_SKY_SPAN = 7,    // top minus bottom 3
  K_FLOOR_DARK = 10, // checker colours 3 + 3
  K_FLOOR_LIGHT = 13,
  K_COUNT = 16,
};

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

SERL_FN float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Lambert with headlight ambient: colour * (0.55 + 0.55 * clip(n . L, 0, 1))
SERL_FN void shade_merge(Hit& best, float t, const float* col, float nx, float ny, float nz,
                         const float* K) {
  const float diff = clip01(nx * K[K_LIGHT] + ny * K[K_LIGHT + 1] + nz * K[K_LIGHT + 2]);
  const float lit = 0.55f + 0.55f * diff;
  merge(best, t, col[0] * lit, col[1] * lit, col[2] * lit);
}

// ray-sphere hit distance (1e9 for a miss) and the unnormalised normal / r
SERL_FN float sphere_t_n(float ox, float oy, float oz, float dx, float dy, float dz, float cx,
                         float cy, float cz, float r, float* n) {
  const float bx = ox - cx, by = oy - cy, bz = oz - cz;
  const float b = bx * dx + by * dy + bz * dz;
  const float cc = bx * bx + by * by + bz * bz - r * r;
  const float disc = b * b - cc;
  float t = -b - sqrtf(fmaxf(disc, 0.0f));
  t = (disc > 0.0f && t > 1e-4f) ? t : 1e9f;
  if (n) {
    const float rinv = 1.0f / fmaxf(r, 1e-9f);
    n[0] = (bx + t * dx) * rinv;
    n[1] = (by + t * dy) * rinv;
    n[2] = (bz + t * dz) * rinv;
  }
  return t;
}

SERL_FN float segment_param(float px, float py, float pz, const float* a, float abx, float aby,
                            float abz, float ab2) {
  return clip01(((px - a[0]) * abx + (py - a[1]) * aby + (pz - a[2]) * abz) / ab2);
}

// swept sphere: project the hit estimate onto the segment, sphere-test there
SERL_FN void capsule(Hit& best, const float* o, const float* d, const float* cap, const float* K) {
  const float* a = cap;
  const float* b = cap + 3;
  const float r = cap[6];
  const float abx = b[0] - a[0], aby = b[1] - a[1], abz = b[2] - a[2];
  const float ab2 = fmaxf(abx * abx + aby * aby + abz * abz, 1e-9f);
  float s = segment_param(o[0], o[1], o[2], a, abx, aby, abz, ab2);
  for (int it = 0; it < 2; ++it) {
    const float t = sphere_t_n(o[0], o[1], o[2], d[0], d[1], d[2], a[0] + s * abx,
                               a[1] + s * aby, a[2] + s * abz, r, nullptr);
    const float ts = t >= 1e9f ? 0.0f : t;
    s = segment_param(o[0] + ts * d[0], o[1] + ts * d[1], o[2] + ts * d[2], a, abx, aby, abz,
                      ab2);
  }
  const float cx = a[0] + s * abx, cy = a[1] + s * aby, cz = a[2] + s * abz;
  const float t = sphere_t_n(o[0], o[1], o[2], d[0], d[1], d[2], cx, cy, cz, r, nullptr);
  const float ts = t >= 1e9f ? 0.0f : t;
  const float nx = o[0] + ts * d[0] - cx;
  const float ny = o[1] + ts * d[1] - cy;
  const float nz = o[2] + ts * d[2] - cz;
  const float inv = 1.0f / fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-9f);
  shade_merge(best, t, cap + 7, nx * inv, ny * inv, nz * inv, K);
}

// oriented-box slab test; the normal is -sign(d . R[:, axis]) R[:, axis] of
// the entry axis (largest slab entry, ties to the first); sign(0) = 0
SERL_FN void box(Hit& best, const float* o, const float* d, const float* bx, const float* K) {
  const float* c = bx;
  const float* R = bx + 3;
  const float* h = bx + 12;
  const float wx = o[0] - c[0], wy = o[1] - c[1], wz = o[2] - c[2];
  float tmin = -1e9f, tmax = 1e9f;
  float entry[3], dl[3];
  for (int k = 0; k < 3; ++k) {
    const float ol = R[k] * wx + R[3 + k] * wy + R[6 + k] * wz;
    dl[k] = R[k] * d[0] + R[3 + k] * d[1] + R[6 + k] * d[2];
    const float den = fabsf(dl[k]) < 1e-9f ? (dl[k] >= 0.0f ? 1e-9f : -1e-9f) : dl[k];
    const float inv = 1.0f / den;
    const float t1 = (-h[k] - ol) * inv;
    const float t2 = (h[k] - ol) * inv;
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

// The uint8 RGB of one pixel: `scene` is the env's row, `cam` 0 (front) or
// 1 (wrist), (gx, gy) the pixel's image-plane coordinates.
SERL_FN void render_pixel(const float* scene, int cam, const float* K, float gx, float gy,
                          unsigned char* rgb) {
  const float* o = scene + cam * CAM_FLOATS;  // position, then rotation
  const float* R = o + 3;
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = R[3 * i] * gx + R[3 * i + 1] * gy - R[3 * i + 2];
  const float inv = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  for (int i = 0; i < 3; ++i) d[i] = d[i] * inv;

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
    const float* col = fmodf(k, 2.0f) == 0.0f ? K + K_FLOOR_DARK : K + K_FLOOR_LIGHT;
    const float lit = K[K_PLANE_LIT];
    merge(best, t, col[0] * lit, col[1] * lit, col[2] * lit);
  }
  for (int i = 0; i < N_SPH; ++i) {
    const float* sp = scene + SPH0 + i * SPH_FLOATS;
    float n[3];
    const float t = sphere_t_n(o[0], o[1], o[2], d[0], d[1], d[2], sp[0], sp[1], sp[2], sp[3], n);
    shade_merge(best, t, sp + 4, n[0], n[1], n[2], K);
  }
  for (int i = 0; i < N_CAP; ++i) capsule(best, o, d, scene + CAP0 + i * CAP_FLOATS, K);
  for (int i = 0; i < N_BOX; ++i) box(best, o, d, scene + BOX0 + i * BOX_FLOATS, K);

  rgb[0] = (unsigned char)(int)(clip01(best.r) * 255.0f);
  rgb[1] = (unsigned char)(int)(clip01(best.g) * 255.0f);
  rgb[2] = (unsigned char)(int)(clip01(best.b) * 255.0f);
}

}  // namespace serl_render
