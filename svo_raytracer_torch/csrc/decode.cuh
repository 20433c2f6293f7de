// Kernel DECODE, per-ray body: one traversal segment's K1 records (status,
// t, cell, widx) and rays turned into the fields of a HitResult.
//
// The same work, in the same order and with the same float32 roundings,
// as ops/wavefront.py::_finish_plain, which is _finish then
// brick_trace.decode_hits in eager ops: the hit voxel (the record's own up
// to G = 32; recomputed from t along the ray, clipped to the brick, for a
// uniform hit when 32 < G <= 64 and for every hit of a paged world, from
// t + 1e-2 there), the attribute word (a flat int32 index, or the row and
// column of 2-D storage; attr16 half-words sign-extended, masked and
// widened), then value, depth, the digit-packed normal over its length
// (raw 555 decodes to 0/0, a NaN, kept), t in world units, the cube's
// edge, the cube corner plus the normal offset, and the hit point.  Each
// layout is a flag of Args, passed by value: one algorithm adapts to the
// world's table.
//
// Device-dependent orders, each taken from torch on that device: a
// tensor divided by a Python scalar is a true division on the CPU and a
// multiply by the float32 reciprocal on the card (both exact for a
// power-of-two world size).  Square roots are correctly rounded sqrtf on
// both, as ops/fp.py's float64 round trip is; divisions of two values
// stay IEEE divisions, and a float-to-int conversion is each device's
// C cast, as torch's.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (decode.cu) and a g++ build for the CPU parity test (decode_host.cpp)
// include the same code; keep the float arithmetic in the plain
// version's order (no fused multiply-add).
#pragma once

#include <math.h>
#include <stdint.h>

namespace dec {

// per-ray status of the trace record (wf_ray.cuh, ops/wavefront.py)
constexpr int32_t MIXED = 1, UNIFORM = 2;
constexpr int32_t BRICK_WORDS = 32768;  // attribute words per mixed brick
constexpr float PAGED_NUDGE = 0x1.47ae14p-7f;  // float32(1e-2), voxel units
constexpr float VOXEL_OFFSET = 0x1.bd70a4p+0f;  // float32(1.74)

// One segment: the world's layout, the record, the rays and fresh
// outputs.  Per-ray arrays are packed (B,) or (B, 3) rows, but for o and
// d, world-space rays read through their strides in floats (a primary
// segment's origins are one camera row, row stride 0).
struct Args {
  int n;
  int G;           // bricks per edge
  int ws;          // world size in voxels
  int capacity;    // mixed-brick slots of the attribute table
  int paged;       // 1 for a paged L0 (G > 64)
  int attr16;      // 1: attribute half-words (_encode_attr16)
  int attr2d;      // 1: 2-D attribute storage, rows of BRICK_WORDS
  int full_depth;  // log2(ws), attr16's depth base
  const int32_t* brick_slot;
  const void* attr;  // int32 words, or int16 half-words
  const int32_t* status;
  const float* t;
  const int32_t* cell;
  const int32_t* widx;
  const float* o;
  int o_row, o_col;
  const float* d;
  int d_row, d_col;
  uint8_t* hit_out;
  int32_t* value_out;
  float* t_out;
  float* scale_out;
  int32_t* depth_out;
  float* normal_out;
  float* hit_pos_out;
  float* voxel_pos_out;
  int32_t* node_out;
};

// torch.div(a, b, rounding_mode="floor") and a % b on int32 (the sign of
// the divisor), b > 0.
__host__ __device__ inline int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__host__ __device__ inline int32_t floormod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}

// x / float(ws) as torch computes it on each device (see the header).
__host__ __device__ inline float over_ws(float x, int ws) {
#ifdef __CUDA_ARCH__
  return x * (1.0f / (float)ws);
#else
  return x / (float)ws;
#endif
}

__host__ __device__ inline int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

__host__ __device__ inline int32_t attr_word(const Args& a, int64_t k) {
  return a.attr16 ? (int32_t)((const int16_t*)a.attr)[k]
                  : ((const int32_t*)a.attr)[k];
}

__host__ __device__ inline void decode(const Args& a, size_t i) {
  const int32_t status = a.status[i];
  const float t_vox = a.t[i];
  const bool hit = status == MIXED || status == UNIFORM;
  const bool uni = status == UNIFORM;
  const int32_t cell = hit ? a.cell[i] : 0;
  int32_t widx = hit ? a.widx[i] : 0;
  const int32_t slot = hit && !uni ? a.brick_slot[cell] : 0;
  const int32_t G = a.G;
  const int32_t bx = floordiv(cell, G * G) * 32;
  const int32_t by = floormod(floordiv(cell, G), G) * 32;
  const int32_t bz = floormod(cell, G) * 32;
  int32_t vx = bx + floordiv(widx, 1024);
  int32_t vy = by + floormod(floordiv(widx, 32), 32);
  int32_t vz = bz + floormod(widx, 32);
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[(size_t)a.o_row * i + (size_t)a.o_col * c];
    d[c] = a.d[(size_t)a.d_row * i + (size_t)a.d_col * c];
  }

  if (G > 32) {  // the record's voxel is not exact: recompute it from t
    if (a.paged ? hit : uni) {
      int32_t u[3];
      const int32_t b[3] = {bx, by, bz};
      for (int c = 0; c < 3; ++c) {
        float p = (o[c] - 1.0f) * (float)a.ws + t_vox * d[c];
        if (a.paged) p = p + d[c] * PAGED_NUDGE;
        u[c] = clip((int32_t)p, b[c], b[c] + 31);
      }
      vx = u[0];
      vy = u[1];
      vz = u[2];
    }
    widx = (vx - bx) * 1024 + (vy - by) * 32 + (vz - bz);
  }

  int32_t raw = 0, node = -1;
  if (a.attr2d) {
    const int32_t row = uni ? a.capacity + (cell >> 15) : slot;
    const int32_t col = uni ? (cell & (BRICK_WORDS - 1)) : widx;
    if (hit) {
      raw = attr_word(a, (int64_t)row * BRICK_WORDS + col);
      node = row;
    }
  } else {
    const int64_t k = uni ? (int64_t)a.capacity * BRICK_WORDS + cell
                          : (int64_t)slot * BRICK_WORDS + widx;
    if (hit) {
      raw = attr_word(a, k);
      node = (int32_t)k;
    }
  }
  int32_t attr = raw;
  if (a.attr16) {  // value(2) | raw(10) << 2 | ddepth(3) << 12
    const int32_t h = raw & 0xFFFF;
    const uint32_t dd = (uint32_t)(a.full_depth - ((h >> 12) & 7));
    attr = h == 0 ? 0
                  : (int32_t)((uint32_t)(h & 3)
                              | ((uint32_t)((h >> 2) & 0x3FF) << 8)
                              | (dd << 24));
  }

  // brick_trace.decode_hits
  const int32_t value = attr & 0xFF;
  const int32_t rn = (attr >> 8) & 0xFFFF;
  const int32_t depth = (attr >> 24) & 0x1F;
  float n[3] = {(float)(rn % 10 - 5),
                (float)((rn % 100 - rn % 10) / 10 - 5),
                (float)((rn - rn % 100) / 100 - 5)};
  const float nlen = sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]);
  for (int c = 0; c < 3; ++c) n[c] = rn != 0 ? n[c] / nlen : 0.0f;

  const float t = over_ws(t_vox, a.ws);
  const float scale = exp2f(-(float)depth);
  int32_t span = a.ws >> clip(depth, 0, 30);
  span = span > 1 ? span : 1;
  const int32_t v[3] = {hit ? vx : -1, hit ? vy : -1, hit ? vz : -1};
  const float off = (scale * 2.0f) * VOXEL_OFFSET;
  const float s2 = scale * 2.0f;
  for (int c = 0; c < 3; ++c) {
    const float corner =
        over_ws((float)(floordiv(v[c], span) * span), a.ws) + 1.0f;
    a.voxel_pos_out[3 * i + c] = corner + n[c] * off;
    a.hit_pos_out[3 * i + c] = (o[c] + t * d[c]) + n[c] * s2;
    a.normal_out[3 * i + c] = n[c];
  }
  a.hit_out[i] = (uint8_t)hit;
  a.value_out[i] = hit ? value : 0;
  a.t_out[i] = t;
  a.scale_out[i] = scale;
  a.depth_out[i] = hit ? depth : 0;
  a.node_out[i] = node;
}

}  // namespace dec
