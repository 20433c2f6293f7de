// CPU build of kernel K2's per-ray body (brick_dda.cuh) and of its
// schedule, for the parity test tests/test_torch_kernel_source.py, which
// compiles this file with g++ -D__host__= -D__device__= -ffp-contract=off
// and compares it with ops/brick_dda.py::coarse_dda_plain.  No runtime
// path uses it: on a GPU the same header is compiled into brick_dda.cu.
//
// The host loop emulates brick_dda.cu's grid: `blocks` blocks of 256
// threads, thread t of block b tracing the rays b*256 + t + j*blocks*256
// below n.  `traced`, if not null, counts the times each ray is traced.  Direction rows lie d_stride floats apart (3, or 0 for one row
// shared by every ray); a null `active` makes every ray active.

#include <stdint.h>

#include "brick_dda.cuh"

namespace {

constexpr int THREADS = 256;

}  // namespace

extern "C" int dda_march_host(const int32_t* table, int G, int max_steps,
                              const float* origins, const float* dirs,
                              int d_stride,
                              const uint8_t* active, int n, uint8_t* hit, float* t, int32_t* cell,
                              int32_t* steps, int blocks, int64_t* traced) {
  const int W = (G + 31) / 32;
  for (int b = 0; b < blocks; ++b) {
    for (int th = 0; th < THREADS; ++th) {
      for (int i = b * THREADS + th; i < n; i += blocks * THREADS) {
        if (traced) ++traced[i];
        const float* o = origins + 3 * (size_t)i;
        const float* d = dirs + (size_t)d_stride * i;
        const dda::Out r = dda::march(
            table, G, W, max_steps, o[0], o[1], o[2], d[0], d[1], d[2],
            active ? active[i] != 0 : true);
        hit[i] = (uint8_t)r.hit;
        t[i] = r.t;
        cell[3 * i] = r.cx;
        cell[3 * i + 1] = r.cy;
        cell[3 * i + 2] = r.cz;
        steps[i] = r.steps;
      }
    }
  }
  return 0;
}
