// CPU build of kernel GI_SHADE's per-ray body (gi_shade.cuh), for the
// parity test tests/test_torch_kernel_source.py, which compiles this file
// with g++ -D__host__= -D__device__= -ffp-contract=off and compares it
// with ops/shade.py::gi_update_plain.  No runtime path uses it: on a GPU
// the same header is compiled into gi_shade.cu.  The arguments are
// gi_shade's, in host memory, less the stream; rays are shaded in turn.

#include <stdint.h>

#include "gi_shade.cuh"

extern "C" int gi_shade_host(int n, int first, const uint32_t* mirror,
                             const uint8_t* active, const float* accum,
                             const float* mask, const float* depth,
                             const int32_t* iters_out, const float* o,
                             int o_row, int o_col, const float* d,
                             int d_row, int d_col,
                             const float* r, const uint8_t* hit,
                             const int32_t* value, const int32_t* iters,
                             const float* t, const float* normal,
                             const float* voxel_pos, float* accum_out,
                             float* mask_out, float* depth_out,
                             int32_t* iters_out_out, uint8_t* active_out,
                             float* o_out, float* d_out) {
  const gi::Args a = gi::make_args(
      n, first, mirror, active, accum, mask, depth, iters_out, o, o_row,
      o_col, d, d_row, d_col, r, hit, value, iters, t, normal, voxel_pos,
      accum_out, mask_out, depth_out, iters_out_out, active_out, o_out,
      d_out);
  for (int i = 0; i < n; ++i) gi::shade(a, i);
  return 0;
}
