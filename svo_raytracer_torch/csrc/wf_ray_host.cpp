// CPU build of kernel K1's per-ray body (wf_ray.cuh) for the parity test
// tests/test_torch_kernel_source.py, which compiles this file with g++
// -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/wavefront.py::trace_plain and, in camera mode, with
// trace_camera_plain.  No runtime path uses it: on a GPU the same header
// is compiled into wavefront.cu.

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
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  for (int i = 0; i < n; ++i) {
    wf::store(wf::trace_ray(T, origins[3 * i], origins[3 * i + 1],
                            origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1],
                            dirs[3 * i + 2], alive[i] != 0),
              i, status, t, cell, widx, iters);
  }
  return 0;
}

extern "C" int wf_trace_camera_host(
    const int32_t* l0_occ, const int32_t* l0_mixed, const int32_t* l0_sc,
    const int32_t* brick_slot, const int32_t* occ_words,
    const int32_t* sc_words, int G, int l0_coarse_base, int zw, int pages,
    const float* cam, int W, int H, int nbx, int world_size, int n,
    int32_t* status, float* t, int32_t* cell, int32_t* widx,
    int32_t* iters) {
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  const wf::Camera C = {cam, W, H, nbx, (float)world_size};
  for (int i = 0; i < n; ++i) {
    wf::store(wf::trace_camera_ray(T, C, i), i, status, t, cell, widx, iters);
  }
  return 0;
}
