// Kernel GI_SHADE, per-ray body: one segment of render mode 0's shading
// (svotrace.comp:443-560) given the segment's hit record.
//
// The same work, in the same order and with the same float32 roundings,
// as ops/shade.py::gi_update_plain: miss shading (the sky on a primary
// miss; on a bounce miss the sun disk, acos(clamp(dot(d, sun), -1, 1)) <
// 0.4, plus ambient, and depth 0), iters where active on the primary
// segment and where hit after it, then on each hit the normal's
// nan_to_num, the cosine-weighted bounce (cosine_bounce) or a mirror's
// reflection, the per-component fallback to -d where the new direction is
// not finite, the albedo (palette, else voxel_pos - 1), mask *= albedo *
// n.l (1 on mirrors), depth, origin and direction.  Both normalisations
// root (x*x + y*y) + z*z summed in float32 with a correctly rounded
// sqrtf, as fp.unit_rows does in float64 (equal bits, ops/fp.py).  The
// shading constants are ops/shade.py's, as float32 bits.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (gi_shade.cu) and a g++ build for the CPU parity test
// (gi_shade_host.cpp) include the same code; keep the float arithmetic in
// the plain version's order (no fused multiply-add).
#pragma once

#include <float.h>
#include <math.h>
#include <stdint.h>

namespace gi {

// ops/shade.py's constants, float32 bits.  Scalars only: device code may
// not index a constexpr array.
constexpr float SUN = 0x1.279a74p-1f;         // each component of SUN_DIR_GI
constexpr float TWO_PI = 0x1.921fb6p+2f;      // float32(2.0 * 3.14159265359)
constexpr float SUN_RADIUS = 0x1.99999ap-2f;  // float32(0.4)
constexpr float AXIS_X = 0x1.99999ap-4f;      // float32(0.1)

__host__ __device__ inline float sky(int c) {  // SKY_COLOR
  return c == 0 ? 0x1.5851ecp-1f : (c == 1 ? 0x1.c1bda6p-1f : 1.0f);
}

__host__ __device__ inline float sky_gradient(int c) {  // SKY_GRADIENT
  return c == 2 ? 0.25f : 0x1.99999ap-2f;
}

// material_color: the palette's albedo of material `value`, else
// `fallback` (voxel_pos - 1).
__host__ __device__ inline float albedo(int32_t value, int c,
                                        float fallback) {
  switch (value) {
    case 1:  // stone
      return c == 0 ? 0x1.ae147ap-1f : (c == 1 ? 0x1.b851ecp-1f
                                                : 0x1.8f5c28p-1f);
    case 2:  // scree
      return c == 0 ? 0x1.23d70ap-1f : (c == 1 ? 0.5f : 0x1.3d70a4p-2f);
    case 3:  // grass
      return c == 0 ? 0x1.7ae148p-2f : (c == 1 ? 0x1.b851ecp-2f
                                                : 0x1.147ae2p-2f);
    default:
      return fallback;
  }
}

// One ray's segment: inputs, then fresh outputs.  Per-ray arrays are
// packed (B,) or (B, 3) rows, but for o and d, read through their strides
// in floats (a primary segment's origins are one camera row, row stride
// 0).  Bool arrays are the bytes of bool tensors.
struct Args {
  int n;
  int first;           // 1 on the primary segment
  uint32_t mirror[8];  // bit v set: material v reflects as a mirror
  const uint8_t* active;
  const float* accum;
  const float* mask;
  const float* depth;
  const int32_t* iters_out;
  const float* o;
  int o_row, o_col;
  const float* d;
  int d_row, d_col;
  const float* r;
  const uint8_t* hit;  // the hit record
  const int32_t* value;
  const int32_t* iters;
  const float* t;
  const float* normal;
  const float* voxel_pos;
  float* accum_out;
  float* mask_out;
  float* depth_out;
  int32_t* iters_out_out;
  uint8_t* active_out;  // the segment's hits: the next segment's active
  float* o_out;
  float* d_out;
};

// The Args of the C entry points' arguments (gi_shade.cu's gi_shade,
// gi_shade_host.cpp's gi_shade_host), `mirror` the mask's 8 words in host
// memory.
inline Args make_args(int n, int first, const uint32_t* mirror,
                      const uint8_t* active, const float* accum,
                      const float* mask, const float* depth,
                      const int32_t* iters_out, const float* o, int o_row,
                      int o_col, const float* d, int d_row, int d_col,
                      const float* r,
                      const uint8_t* hit, const int32_t* value,
                      const int32_t* iters, const float* t,
                      const float* normal, const float* voxel_pos,
                      float* accum_out, float* mask_out, float* depth_out,
                      int32_t* iters_out_out, uint8_t* active_out,
                      float* o_out, float* d_out) {
  Args a = {n,         first,     {},        active,        accum,
            mask,      depth,     iters_out, o,             o_row,
            o_col,     d,         d_row,     d_col,         r,
            hit,       value,     iters,     t,             normal,
            voxel_pos, accum_out, mask_out,  depth_out,     iters_out_out,
            active_out, o_out,    d_out};
  for (int k = 0; k < 8; ++k) a.mirror[k] = mirror[k];
  return a;
}

// torch's sum over a row of three floats, in each device's order: the
// CPU's reduction adds x, y, z in turn; the card's reduce kernel runs
// two lanes on a row, x + z on one and y on the other, and adds them.
// Both start from +0, so a zero sum is +0.
__host__ __device__ inline float sum3(float x, float y, float z) {
#ifdef __CUDA_ARCH__
  return ((x + z) + y) + 0.0f;
#else
  return ((x + y) + z) + 0.0f;
#endif
}

// torch.nan_to_num's defaults: NaN to 0, +-inf to +-FLT_MAX.
__host__ __device__ inline float nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (x == INFINITY) return FLT_MAX;
  if (x == -INFINITY) return -FLT_MAX;
  return x;
}

// fp.unit_rows: v over sqrt((x*x + y*y) + z*z).
__host__ __device__ inline void unit(float v[3]) {
  const float len = sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
  v[0] = v[0] / len;
  v[1] = v[1] / len;
  v[2] = v[2] / len;
}

__host__ __device__ inline void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The bounce direction and n.l of a hit ray (d its incoming direction,
// w its nan_to_num normal, r its random): cosine_bounce, or mirror_bounce
// for a mirror, then -d for each component that is not finite.
__host__ __device__ inline float bounce(const float d[3], const float w[3],
                                        float r, bool mirror,
                                        float out[3]) {
  if (mirror) {
    const float ndot = sum3(d[0] * w[0], d[1] * w[1], d[2] * w[2]);
    for (int c = 0; c < 3; ++c) out[c] = d[c] - (2.0f * ndot) * w[c];
  } else {
    const bool use_y = fabsf(w[0]) > AXIS_X;
    const float axis[3] = {use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f};
    float u[3], v[3];
    cross(axis, w, u);
    unit(u);
    cross(w, u, v);
    const float ang = TWO_PI * r;
    const float ca = cosf(ang), sa = sinf(ang), omr = 1.0f - r;
    for (int c = 0; c < 3; ++c)
      out[c] = (u[c] * ca + v[c] * sa) + w[c] * omr;
    unit(out);
  }
  for (int c = 0; c < 3; ++c)
    if (!isfinite(out[c])) out[c] = -d[c];
  return mirror ? 1.0f : sum3(out[0] * w[0], out[1] * w[1], out[2] * w[2]);
}

// Whether bit `value` of the mirror mask is set (values outside [0, 255]
// are no mirror); the word is chosen by selects, not by an index, so the
// mask stays in the kernel's parameters.
__host__ __device__ inline bool is_mirror(const Args& a, int32_t value) {
  if (value < 0 || value > 255) return false;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) word = (value >> 5) == k ? a.mirror[k] : word;
  return (word >> (value & 31)) & 1u;
}

__host__ __device__ inline void shade(const Args& a, size_t i) {
  float acc[3], msk[3], o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    acc[c] = a.accum[3 * i + c];
    msk[c] = a.mask[3 * i + c];
    o[c] = a.o[(size_t)a.o_row * i + (size_t)a.o_col * c];
    d[c] = a.d[(size_t)a.d_row * i + (size_t)a.d_col * c];
  }
  float depth = a.depth[i];
  int32_t iters_out = a.iters_out[i];
  const bool active = a.active[i] != 0;
  const bool rhit = active && a.hit[i] != 0;
  const bool miss = active && !rhit;

  if (a.first) {  // primary miss: the sky gradient
    if (miss)
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + (sky(c) - d[1] * sky_gradient(c));
    if (active) iters_out = a.iters[i];
  } else {  // bounce miss: the sun disk and ambient
    if (miss) {
      float cs = sum3(d[0] * SUN, d[1] * SUN, d[2] * SUN);
      // clamp(-1, 1), NaN kept
      cs = cs < -1.0f ? -1.0f : (cs > 1.0f ? 1.0f : cs);
      const bool sun = acosf(cs) < SUN_RADIUS;
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + ((sun ? msk[c] * 7.0f : 0.0f) + msk[c]);
      depth = 0.0f;
    }
    if (rhit) iters_out = a.iters[i];
  }

  if (rhit) {
    const int32_t value = a.value[i];
    float w[3], vp[3], nd[3];
    for (int c = 0; c < 3; ++c) {
      w[c] = nan_to_num(a.normal[3 * i + c]);
      vp[c] = a.voxel_pos[3 * i + c];
    }
    const bool mirror = is_mirror(a, value);
    const float ndotl = bounce(d, w, a.r[i], mirror, nd);
    for (int c = 0; c < 3; ++c) {
      msk[c] = (msk[c] * albedo(value, c, vp[c] - 1.0f)) * ndotl;
      o[c] = vp[c];
      d[c] = nd[c];
    }
    depth = a.t[i];
  }

  for (int c = 0; c < 3; ++c) {
    a.accum_out[3 * i + c] = acc[c];
    a.mask_out[3 * i + c] = msk[c];
    a.o_out[3 * i + c] = o[c];
    a.d_out[3 * i + c] = d[c];
  }
  a.depth_out[i] = depth;
  a.iters_out_out[i] = iters_out;
  a.active_out[i] = (uint8_t)rhit;
}

}  // namespace gi
