// CPU build of kernel K3's per-ray body (brick_round.cuh) and of its
// schedule, for the parity test tests/test_torch_kernel_source.py, which
// compiles this file with g++ -D__host__= -D__device__= -ffp-contract=off
// and compares it with ops/brick_pallas.py::trace_plain.  No runtime path
// uses it: on a GPU the same header is compiled into brick_round.cu.
//
// The host loop emulates brick_round.cu's grid, one id per thread: id k
// traces ray order[k] (or ray k), its record written to that ray's slot.
// `traced`, if not null, receives the ray traced at each id.

#include <stdint.h>

#include "brick_round.cuh"

extern "C" int brick_round_host(const int32_t* l0, const int32_t* brick_slot,
                                const int32_t* brick_attr,
                                const int32_t* occ, const int32_t* attrs,
                                int G, int max_rounds, const float* origins,
                                const float* dirs, const uint8_t* alive,
                                const int64_t* order, int n, uint8_t* hit,
                                int32_t* attr, int32_t* hvox, float* t,
                                int32_t* iters, int64_t* traced) {
  const br::Scene S = {l0, brick_slot, brick_attr, occ, attrs, G, 32 * G};
  for (int k = 0; k < n; ++k) {
    const int i = order ? (int)order[k] : k;
    if (traced) traced[k] = i;
    const br::Out r = br::trace_ray(
        S, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
        dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], alive[i] != 0,
        max_rounds);
    hit[i] = (uint8_t)r.hit;
    attr[i] = r.attr;
    hvox[i] = r.hvox;
    t[i] = r.t;
    iters[i] = r.iters;
  }
  return 0;
}
