// Kernel KE, per-ray body: the Laine-Karras ESVO stack traversal of one ray.
//
// The JAX package has no Pallas kernel for this walk: it runs
// svo_raytracer_tpu/ops/traverse.py::intersect_octree as an XLA
// while_loop (:415-423) over `_make_step` (:182-322), every ray of the
// batch stepping in lock-step under masks.  Here one thread owns one ray
// and loops `step` until the ray is done or reaches the per-ray cap, the
// reference's own design (svotrace.comp:211-432, one GL thread per pixel).
// Per-ray state evolves from that ray's state alone, so the per-thread loop
// gives the lock-step batch's answer and the same iteration count, in
// whatever order esvo.cu's schedule takes the rays.
//
// Ray setup is traverse.py::_setup (:100-179); the step is _make_step's
// PUSH / ADVANCE / POP, with its float-mantissa POP (31 - clz of the
// differing position bits) and the parent-word stack: the reference
// stacks (node, packed word) per scale in [MAX_SCALE - stack_depth,
// MAX_SCALE), unstored slots read as (0, 0), and a pop onto node 0 takes
// the root's word.  Here the stack keeps the node only: the word of node
// p is always packed[p] (the root's for p = 0), so a POP reloads it from
// the table.  A mask of the slots this ray stored stands in for zeroed
// arrays (an unstored slot pops node 0, so the root's word), so nothing is
// cleared; a stored slot keeps its entry until it is overwritten, as in
// the reference.  The array is indexed by scale, 23 x 4 B of local memory
// of which the stack_depth window is used (PERF.md §6 has the places
// measured for it: cleared node and word arrays, node and word in
// shared memory, node only in shared memory).  The outputs are the state
// fields traverse.py::_decode reads (_DECODE_STATE, :435-436); the decode
// itself stays in PyTorch.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (esvo.cu) and a g++ build for the CPU parity test (esvo_host.cpp)
// include the same code.  The plain PyTorch version is
// ops/traverse.py::intersect_plain; keep the float arithmetic in the same
// order (no fused multiply-add: nvcc builds with -fmad=false, g++ with
// -ffp-contract=off), and min/max propagate NaN as torch.minimum does.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "fp.cuh"

namespace esvo {

constexpr int MAX_SCALE = 23;
constexpr float EPS = 3.552713678800501e-15f;  // 2^-48, svotrace.comp:31

struct State {
  float t_min, t_max;
  int32_t idx;
  float px, py, pz;
  int32_t parent, scale;
  float scale_exp2;
  int32_t iters, done;
};

using fp::maxf;
using fp::minf;

__host__ __device__ inline uint32_t bits(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}

__host__ __device__ inline float from_bits(uint32_t u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}

// findMSB on uint32 (svotrace.comp:352): 31 - clz, -1 for 0.
__host__ __device__ inline int32_t find_msb(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz((int)x);
#else
  return x == 0 ? -1 : 31 - __builtin_clz(x);
#endif
}

__host__ __device__ inline float clamp_dir(float v) {
  return fabsf(v) < EPS ? (v >= 0.0f ? EPS : -EPS) : v;
}

// A table word, through the read-only data cache on the card.
__host__ __device__ inline int32_t ldg(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// The bin by which esvo.cu regroups the rays of a cone-traced segment
// within a block: the octant as trace_ray's setup computes it (bit 0 x,
// 1 y, 2 z; set where the clamped component is > 0), or DEAD_BIN for a
// ray that retires at once (not active or not finite).
constexpr int DEAD_BIN = 8;

__host__ __device__ inline int ray_bin(float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       bool active) {
  if (!(active && isfinite(ox) && isfinite(oy) && isfinite(oz) &&
        isfinite(dx) && isfinite(dy) && isfinite(dz))) {
    return DEAD_BIN;
  }
  return (clamp_dir(dx) > 0.0f ? 1 : 0) | (clamp_dir(dy) > 0.0f ? 2 : 0) |
         (clamp_dir(dz) > 0.0f ? 4 : 0);
}

// packed: (n,) words (effective child base << 1) | value != 0
// (traverse.py::make_packed_table).  stack_depth <= MAX_SCALE.
__host__ __device__ inline State trace_ray(
    const int32_t* packed, float ox, float oy, float oz, float dx0,
    float dy0, float dz0, bool active, int max_depth, bool cone,
    int max_it, int stack_depth) {
  // ---- _setup (svotrace.comp:226-257)
  const float dx = clamp_dir(dx0), dy = clamp_dir(dy0), dz = clamp_dir(dz0);
  const float cx = 1.0f / -fabsf(dx);
  const float cy = 1.0f / -fabsf(dy);
  const float cz = 1.0f / -fabsf(dz);
  float bx = cx * ox, by = cy * oy, bz = cz * oz;
  const int32_t octant = (dx > 0.0f ? 1 : 0) | (dy > 0.0f ? 2 : 0)
                         | (dz > 0.0f ? 4 : 0);
  if (dx > 0.0f) bx = 3.0f * cx - bx;
  if (dy > 0.0f) by = 3.0f * cy - by;
  if (dz > 0.0f) bz = 3.0f * cz - bz;

  State s;
  s.t_min = maxf(maxf(2.0f * cx - bx, 2.0f * cy - by), 2.0f * cz - bz);
  s.t_max = minf(minf(cx - bx, cy - by), cz - bz);
  s.t_min = maxf(s.t_min, 0.0f);
  float h = s.t_max;
  const bool cxs = 1.5f * cx - bx > s.t_min;
  const bool cys = 1.5f * cy - by > s.t_min;
  const bool czs = 1.5f * cz - bz > s.t_min;
  s.idx = (cxs ? 1 : 0) | (cys ? 2 : 0) | (czs ? 4 : 0);
  s.px = cxs ? 1.5f : 1.0f;
  s.py = cys ? 1.5f : 1.0f;
  s.pz = czs ? 1.5f : 1.0f;
  const bool finite = isfinite(ox) && isfinite(oy) && isfinite(oz)
                      && isfinite(dx0) && isfinite(dy0) && isfinite(dz0);
  s.done = !(active && finite);
  s.parent = 0;
  s.scale = MAX_SCALE - 1;
  s.scale_exp2 = 0.5f;
  s.iters = 0;

  const int32_t root_word = ldg(packed);
  int32_t parent_word = root_word;
  const int lo = MAX_SCALE - stack_depth;
  int32_t stack_node[MAX_SCALE];  // slot s holds a node if bit s is set
  uint32_t written = 0u;

  // ---- _make_step, until done or the per-ray cap (svotrace.comp:262-376)
  while (!s.done && s.iters < max_it) {
    s.iters += 1;
    // cone-trace LOD clamp, sticky (svotrace.comp:275-277)
    if (cone && s.t_min > 0.05f) max_depth = 11;

    const float tx_corner = s.px * cx - bx;
    const float ty_corner = s.py * cy - by;
    const float tz_corner = s.pz * cz - bz;
    const float tc_max = minf(minf(tx_corner, ty_corner), tz_corner);

    const int32_t child_shift = s.idx ^ octant;
    const int32_t ci = (parent_word >> 1) + child_shift;
    const int32_t cword = ldg(packed + ci);
    const bool hit_cond = (cword & 1) != 0 && s.t_min <= s.t_max;
    if (hit_cond && MAX_SCALE - s.scale == max_depth) {
      s.done = 1;  // depth cutoff: hit at this cube
      continue;
    }
    const float tv_max = minf(s.t_max, tc_max);
    const float half = s.scale_exp2 * 0.5f;
    if (hit_cond && s.t_min <= tv_max) {
      if ((cword >> 1) == 0) {
        s.done = 1;  // leaf hit
        continue;
      }
      // ---- PUSH (svotrace.comp:315-334)
      if (tc_max < h && s.scale >= lo) {
        stack_node[s.scale] = s.parent;
        written |= 1u << s.scale;
      }
      h = tc_max;
      s.parent = ci;
      parent_word = cword;
      const float tx_center = half * cx + tx_corner;
      const float ty_center = half * cy + ty_corner;
      const float tz_center = half * cz + tz_corner;
      const bool cxm = tx_center > s.t_min;
      const bool cym = ty_center > s.t_min;
      const bool czm = tz_center > s.t_min;
      s.idx = (cxm ? 1 : 0) | (cym ? 2 : 0) | (czm ? 4 : 0);
      if (cxm) s.px = s.px + half;
      if (cym) s.py = s.py + half;
      if (czm) s.pz = s.pz + half;
      s.scale -= 1;
      s.scale_exp2 = half;
      s.t_max = tv_max;
      continue;
    }

    // ---- ADVANCE (svotrace.comp:337-344)
    const bool sx = tx_corner <= tc_max;
    const bool sy = ty_corner <= tc_max;
    const bool sz = tz_corner <= tc_max;
    const int32_t step_mask = (sx ? 1 : 0) | (sy ? 2 : 0) | (sz ? 4 : 0);
    const float apx = sx ? s.px - s.scale_exp2 : s.px;
    const float apy = sy ? s.py - s.scale_exp2 : s.py;
    const float apz = sz ? s.pz - s.scale_exp2 : s.pz;
    s.t_min = tc_max;
    s.idx ^= step_mask;

    if ((s.idx & step_mask) == 0) {
      s.px = apx;
      s.py = apy;
      s.pz = apz;
      continue;
    }
    // ---- POP (svotrace.comp:347-368)
    uint32_t differing = 0u;
    if (sx) differing |= bits(apx) ^ bits(apx + s.scale_exp2);
    if (sy) differing |= bits(apy) ^ bits(apy + s.scale_exp2);
    if (sz) differing |= bits(apz) ^ bits(apz + s.scale_exp2);
    const int32_t new_scale = find_msb(differing);
    const int32_t safe = new_scale < 0 ? 0
                         : (new_scale > MAX_SCALE ? MAX_SCALE : new_scale);
    int32_t pop_parent = 0;
    if (safe >= lo && safe < MAX_SCALE && ((written >> safe) & 1u)) {
      pop_parent = stack_node[safe];
    }
    const int32_t pop_word =
        pop_parent == 0 ? root_word : ldg(packed + pop_parent);
    const uint32_t su = (uint32_t)safe;
    const uint32_t shx = bits(apx) >> su;
    const uint32_t shy = bits(apy) >> su;
    const uint32_t shz = bits(apz) >> su;
    // the popped parent cube's exit t, from the position truncated to
    // scale + 1 mantissa bits (traverse.py:296-306)
    const uint32_t up = su + 1u;
    const float par_px = from_bits((bits(apx) >> up) << up);
    const float par_py = from_bits((bits(apy) >> up) << up);
    const float par_pz = from_bits((bits(apz) >> up) << up);
    s.scale = new_scale;
    s.scale_exp2 = from_bits((uint32_t)(new_scale - MAX_SCALE + 127) << 23);
    s.parent = pop_parent;
    parent_word = pop_word;
    s.t_max = minf(minf(par_px * cx - bx, par_py * cy - by),
                   par_pz * cz - bz);
    s.px = from_bits(shx << su);
    s.py = from_bits(shy << su);
    s.pz = from_bits(shz << su);
    s.idx = (int32_t)((shx & 1u) | ((shy & 1u) << 1) | ((shz & 1u) << 2));
    h = 0.0f;
    if (s.scale >= MAX_SCALE) s.done = 1;  // left the root cube
  }
  return s;
}

}  // namespace esvo
