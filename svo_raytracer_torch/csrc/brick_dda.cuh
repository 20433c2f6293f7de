// Kernel K2, per-ray body: the coarse occupancy-grid DDA of one ray.
//
// Replaces the per-lane arithmetic of svo_raytracer_tpu/ops/brick_dda.py
// ::_dda_kernel (:85-193): an Amanatides-Woo DDA through a G^3 grid of
// z-packed occupancy bits (word (x*G + y)*W + z/32, bit z%32, W =
// ceil(G/32)), reporting the first solid cell, its entry t (grid units),
// the cell and the step count.  Rays outside [0, G]^3 first advance to
// the box entry (+1e-4); direction components clamp to +-1e-4.  The TPU
// kernel runs a fixed 3G masked steps per 1024-ray tile, fetching words
// by a composite lane gather; here a thread stops once its ray hits or
// leaves the grid, after which the masked steps change nothing.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (brick_dda.cu) and a g++ build for the CPU parity test
// (brick_dda_host.cpp) include the same code.  The plain PyTorch version
// is ops/brick_dda.py::coarse_dda_plain; keep the float arithmetic in the
// same order (no fused multiply-add), with NaN-propagating min/max.
#pragma once

#include <math.h>
#include <stdint.h>

#include "fp.cuh"

namespace dda {

struct Out {
  int32_t hit;
  float t;     // entry t of the hit cell (grid units), else how far it got
  int32_t cx, cy, cz;
  int32_t steps;
};

__host__ __device__ inline float clamp_dir(float v) {
  return fabsf(v) < 1e-4f ? (v >= 0.0f ? 1e-4f : -1e-4f) : v;
}

// int32(p) clipped to [0, G-1]; out-of-range and NaN p take the clipped
// saturating conversion, as XLA's and CUDA's float-to-int do.
__host__ __device__ inline int cell_of(float p, int G) {
  if (!(p > -1.0f)) return 0;
  if (p >= (float)G) return G - 1;
  const int i = (int)p;
  return i < 0 ? 0 : (i > G - 1 ? G - 1 : i);
}

// tab: the G*G*W packed words.  o, d in grid units.
__host__ __device__ inline Out march(const int32_t* tab, int G, int W,
                                     int max_steps, float ox, float oy,
                                     float oz, float dx0, float dy0,
                                     float dz0, bool act) {
  const float dx = clamp_dir(dx0), dy = clamp_dir(dy0), dz = clamp_dir(dz0);
  const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
  const float gf = (float)G;
  const float t1x = (0.0f - ox) * inv_x, t2x = (gf - ox) * inv_x;
  const float t1y = (0.0f - oy) * inv_y, t2y = (gf - oy) * inv_y;
  const float t1z = (0.0f - oz) * inv_z, t2z = (gf - oz) * inv_z;
  const float t_ent = fp::maxf(fp::maxf(fp::minf(t1x, t2x),
                                        fp::minf(t1y, t2y)),
                               fp::minf(t1z, t2z));
  const float t_exit = fp::minf(fp::minf(fp::maxf(t1x, t2x),
                                         fp::maxf(t1y, t2y)),
                                fp::maxf(t1z, t2z));
  const float t0 = fp::maxf(t_ent, 0.0f);
  const bool misses_box = (t_ent > t_exit) || (t_exit < 0.0f);
  // nudge inside the entry cell; rays already inside keep their origin
  const float base_t = t0 > 0.0f ? t0 + 1e-4f : 0.0f;
  const float px = ox + base_t * dx;
  const float py = oy + base_t * dy;
  const float pz = oz + base_t * dz;

  Out r;
  r.cx = cell_of(px, G);
  r.cy = cell_of(py, G);
  r.cz = cell_of(pz, G);
  const int sx = dx > 0.0f ? 1 : -1;
  const int sy = dy > 0.0f ? 1 : -1;
  const int sz = dz > 0.0f ? 1 : -1;
  float tx = base_t + ((float)(dx > 0.0f ? r.cx + 1 : r.cx) - px) * inv_x;
  float ty = base_t + ((float)(dy > 0.0f ? r.cy + 1 : r.cy) - py) * inv_y;
  float tz = base_t + ((float)(dz > 0.0f ? r.cz + 1 : r.cz) - pz) * inv_z;
  const float adx = fabsf(inv_x), ady = fabsf(inv_y), adz = fabsf(inv_z);
  const bool alive0 = act && !misses_box;
  r.t = alive0 ? base_t : 0.0f;
  r.hit = 0;
  r.steps = 0;
  for (int s = 0; s < max_steps; ++s) {
    const bool inside = r.cx >= 0 && r.cx < G && r.cy >= 0 && r.cy < G
                        && r.cz >= 0 && r.cz < G;
    if (!(alive0 && inside)) break;
    const uint32_t word = (uint32_t)tab[(r.cx * G + r.cy) * W + (r.cz >> 5)];
    if ((word >> (r.cz & 31)) & 1u) {
      r.hit = 1;
      break;
    }
    r.steps += 1;
    const bool mx = tx <= ty && tx <= tz;
    const bool my = !mx && ty <= tz;
    r.t = fp::minf(fp::minf(tx, ty), tz);
    if (mx) {
      r.cx += sx;
      tx = tx + adx;
    } else if (my) {
      r.cy += sy;
      ty = ty + ady;
    } else {
      r.cz += sz;
      tz = tz + adz;
    }
  }
  return r;
}

}  // namespace dda
