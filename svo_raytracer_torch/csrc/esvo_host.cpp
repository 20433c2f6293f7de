// CPU build of kernel KE's per-ray body (esvo_ray.cuh) and of its
// schedule, for the parity test tests/test_torch_kernel_source.py, which
// compiles this file with g++ -D__host__= -D__device__= -ffp-contract=off
// and compares it with ops/traverse.py::intersect_plain.  No runtime path
// uses it: on a GPU the same header is compiled into esvo.cu.
//
// The host loop emulates esvo.cu's blocks: block b takes ids
// [128 b, 128 b + 128) and traces ray order[id] (or ray id), its record
// written to that ray's slot; on a cone-traced segment the block's rays
// are first regrouped by esvo::ray_bin (stably here; the card's order
// within a bin is that of its atomics, which no record depends on).
// `traced`, if not null, receives the ray traced at each position.

#include <stdint.h>

#include "esvo_ray.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BINS = esvo::DEAD_BIN + 1;

}  // namespace

extern "C" int esvo_trace_host(const int32_t* packed, const float* origins,
                               const float* dirs, const uint8_t* active,
                               const int64_t* order, int n, int max_depth,
                               int cone, int max_it, int stack_depth,
                               float* f_out, int32_t* i_out,
                               int64_t* traced) {
  for (int base = 0; base < n; base += THREADS) {
    const int m = n - base < THREADS ? n - base : THREADS;
    int ids[THREADS];
    for (int t = 0; t < m; ++t) {
      ids[t] = order ? (int)order[base + t] : base + t;
    }
    if (cone) {
      int bin[THREADS], start[BINS + 1] = {0}, sorted[THREADS];
      for (int t = 0; t < m; ++t) {
        const int i = ids[t];
        bin[t] = esvo::ray_bin(origins[3 * i], origins[3 * i + 1],
                               origins[3 * i + 2], dirs[3 * i],
                               dirs[3 * i + 1], dirs[3 * i + 2],
                               active[i] != 0);
        ++start[bin[t] + 1];
      }
      for (int b = 0; b < BINS; ++b) start[b + 1] += start[b];
      for (int t = 0; t < m; ++t) sorted[start[bin[t]]++] = ids[t];
      for (int t = 0; t < m; ++t) ids[t] = sorted[t];
    }
    for (int t = 0; t < m; ++t) {
      const int i = ids[t];
      if (traced) traced[base + t] = i;
      const esvo::State s = esvo::trace_ray(
          packed, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
          dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], active[i] != 0,
          max_depth, cone != 0, max_it, stack_depth);
      f_out[i] = s.t_min;
      f_out[n + i] = s.t_max;
      f_out[2 * n + i] = s.px;
      f_out[3 * n + i] = s.py;
      f_out[4 * n + i] = s.pz;
      f_out[5 * n + i] = s.scale_exp2;
      i_out[i] = s.idx;
      i_out[n + i] = s.parent;
      i_out[2 * n + i] = s.scale;
      i_out[3 * n + i] = s.iters;
      i_out[4 * n + i] = s.done;
    }
  }
  return 0;
}
