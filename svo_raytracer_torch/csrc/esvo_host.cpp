// CPU build of kernel KE's per-ray body (esvo_ray.cuh) for the parity test
// tests/test_torch_kernel_source.py, which compiles this file with g++
// -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/traverse.py::intersect_plain.  No runtime path uses it: on a GPU the
// same header is compiled into esvo.cu.

#include <stdint.h>

#include "esvo_ray.cuh"

extern "C" int esvo_trace_host(const int32_t* packed, const float* origins,
                               const float* dirs, const uint8_t* active,
                               int n, int max_depth, int cone, int max_it,
                               int stack_depth, float* f_out,
                               int32_t* i_out) {
  for (int i = 0; i < n; ++i) {
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
  return 0;
}
