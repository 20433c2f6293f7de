// CPU build of kernel K1's per-ray body (wf_ray.cuh) for the parity test
// tests/test_torch_kernel_source.py, which compiles this file with g++
// -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/wavefront.py::trace_plain.  No runtime path uses it: on a GPU the
// same header is compiled into wavefront.cu.

#include <stdint.h>

#include "wf_ray.cuh"

extern "C" int wf_trace_host(const int32_t* l0_occ, const int32_t* l0_mixed,
                             const int32_t* l0_sc, const int32_t* brick_slot,
                             const int32_t* occ_words,
                             const int32_t* sc_words, int G,
                             int l0_coarse_base, int zw, int pages,
                             const float* origins,
                             const float* dirs, const uint8_t* alive, int n,
                             int32_t* status, float* t, int32_t* cell,
                             int32_t* widx, int32_t* iters) {
  wf::Tables T;
  T.l0_occ = l0_occ;
  T.l0_mixed = l0_mixed;
  T.l0_sc = l0_sc;
  T.brick_slot = brick_slot;
  T.occ_words = occ_words;
  T.sc_words = sc_words;
  T.G = G;
  T.l0_coarse_base = l0_coarse_base;
  T.zw = zw;
  T.pages = pages;
  for (int i = 0; i < n; ++i) {
    const wf::RayOut r = wf::trace_ray(
        T, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
        dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], alive[i] != 0);
    status[i] = r.status;
    t[i] = r.t;
    cell[i] = r.cell;
    widx[i] = r.widx;
    iters[i] = r.iters;
  }
  return 0;
}
