// CPU build of kernel DECODE's per-ray body (decode.cuh), for the parity
// test tests/test_torch_kernel_source.py, which compiles this file with
// g++ -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/wavefront.py::_finish_plain.  No runtime path uses it: on a GPU the
// same header is compiled into decode.cu.  The arguments are decode's, in
// host memory, less the stream; rays are decoded in turn.

#include <stdint.h>

#include "decode.cuh"

extern "C" int decode_host(int n, int G, int ws, int capacity, int paged,
                           int attr16, int attr2d, int full_depth,
                           const int32_t* brick_slot, const void* attr,
                           const int32_t* status, const float* t,
                           const int32_t* cell, const int32_t* widx,
                           const float* o, int o_row, int o_col,
                           const float* d, int d_row, int d_col,
                           uint8_t* hit_out, int32_t* value_out,
                           float* t_out, float* scale_out,
                           int32_t* depth_out, float* normal_out,
                           float* hit_pos_out, float* voxel_pos_out,
                           int32_t* node_out) {
  const dec::Args a = {n,         G,           ws,         capacity,
                       paged,     attr16,      attr2d,     full_depth,
                       brick_slot, attr,       status,     t,
                       cell,      widx,        o,          o_row,
                       o_col,     d,           d_row,      d_col,
                       hit_out,   value_out,   t_out,      scale_out,
                       depth_out, normal_out,  hit_pos_out, voxel_pos_out,
                       node_out};
  for (int i = 0; i < n; ++i) dec::decode(a, i);
  return 0;
}
