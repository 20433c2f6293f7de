// CPU build of kernel K2's per-ray body (brick_dda.cuh) for the parity
// test tests/test_torch_kernel_source.py, which compiles this file with
// g++ -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/brick_dda.py::coarse_dda_plain.  No runtime path uses it: on a GPU
// the same header is compiled into brick_dda.cu.

#include <stdint.h>

#include "brick_dda.cuh"

extern "C" int dda_march_host(const int32_t* table, int G, int max_steps,
                              const float* origins, const float* dirs,
                              const uint8_t* active, int n, int32_t* hit,
                              float* t, int32_t* cell, int32_t* steps) {
  const int W = (G + 31) / 32;
  for (int i = 0; i < n; ++i) {
    const dda::Out r = dda::march(
        table, G, W, max_steps, origins[3 * i], origins[3 * i + 1],
        origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2],
        active[i] != 0);
    hit[i] = r.hit;
    t[i] = r.t;
    cell[3 * i] = r.cx;
    cell[3 * i + 1] = r.cy;
    cell[3 * i + 2] = r.cz;
    steps[i] = r.steps;
  }
  return 0;
}
