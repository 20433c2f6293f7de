// Kernel DECODE: one traversal segment's K1 records turned into its
// HitResult, one thread per ray.
//
// Replaces no TPU kernel: the JAX package leaves the decode
// (svo_raytracer_tpu/ops/wavefront.py::_finish and
// brick_trace.decode_hits) to XLA, which fuses its elementwise glue.
// Eager PyTorch ran it as ~110 kernels a segment
// (ops/wavefront.py::_finish_plain, the plain version); this runs the
// whole segment in registers.  The per-ray body is decode.cuh.
//
// What bounds it on Hopper: device memory.  A ray reads its record's
// status and t (8 B), its cell and widx where it hit (8 B), its origin
// and direction (24 B; 12 B on a primary segment, whose origins are one
// camera row read in place, row stride 0), brick_slot where it hit a
// mixed brick (4 B) and its attribute word where it hit (4 B, 2 B as
// attr16), and writes hit 1, value 4, t 4, scale_exp2 4, depth 4,
// normal 12, hit_pos 12, voxel_pos 12 and node 4 (57 B): at most 105 B
// a ray, 93 B on a primary; a miss reads 32 B (20 B).  Its arithmetic (a
// square root, four divisions, ~80 integer and float operations) is far
// below that.  What the design does:
//   * one launch, no copies: records and outputs are packed (B,) or
//     (B, 3) tensors, origins and directions are read through their
//     strides, the world's layout (G, paged, attr16, 2-D storage)
//     arrives by value, so the wrapper launches this alone;
//   * a ray reads its cell and widx, and gathers its attribute word, only
//     where it hit, and brick_slot only on a mixed hit;
//   * `iters` is not read: the HitResult keeps the record's tensor.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/wavefront.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) decode_kernel(dec::Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) dec::decode(a, i);
}

}  // namespace

// The arrays of dec::Args (decode.cuh), on the card.  Launches one thread
// per ray on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int decode(int n, int G, int ws, int capacity, int paged,
                      int attr16, int attr2d, int full_depth,
                      const int32_t* brick_slot, const void* attr,
                      const int32_t* status, const float* t,
                      const int32_t* cell, const int32_t* widx,
                      const float* o, int o_row, int o_col, const float* d,
                      int d_row, int d_col, uint8_t* hit_out,
                      int32_t* value_out, float* t_out, float* scale_out,
                      int32_t* depth_out, float* normal_out,
                      float* hit_pos_out, float* voxel_pos_out,
                      int32_t* node_out, void* stream) {
  if (n <= 0) return 0;
  const dec::Args a = {n,         G,           ws,         capacity,
                       paged,     attr16,      attr2d,     full_depth,
                       brick_slot, attr,       status,     t,
                       cell,      widx,        o,          o_row,
                       o_col,     d,           d_row,      d_col,
                       hit_out,   value_out,   t_out,      scale_out,
                       depth_out, normal_out,  hit_pos_out, voxel_pos_out,
                       node_out};
  decode_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
