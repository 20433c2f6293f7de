// Kernel GI_SHADE: one segment of render mode 0's shading, one thread per
// ray.
//
// Replaces no TPU kernel: the JAX package leaves the shading in
// svo_raytracer_tpu/ops/shade.py's shade_gi loop to XLA, which fuses its
// elementwise glue.  Eager PyTorch ran it as ~87 kernels a segment
// (ops/shade.py::gi_update_plain, the plain version); this runs the whole
// segment in registers.  The per-ray body is gi_shade.cuh.
//
// What bounds it on Hopper: device memory.  A segment reads up to 98 B a
// ray (the state: active 1, accum 12, mask 12, depth 4, iters 4, origin
// 12, direction 12, random 4; the hit record: hit 1, value 4, iters 4,
// t 4, normal 12, voxel_pos 12) and writes 57 B (accum, mask, origin and
// direction 12 each, depth 4, iters 4, active 1): 155 B, 143 B on a
// primary segment, whose origins are one camera row read in place
// (row stride 0).  Its arithmetic (an acos, a cos and a sin, two square
// roots, ~100 flops) is far below that.  What the design does:
//   * one launch, no copies — the bool tensors' bytes are its u8 input
//     and output, origins and directions are read through their strides,
//     the mirror materials arrive as a 256-bit mask by value and the
//     shading constants are literals, so the wrapper launches this alone;
//   * fresh outputs — the inputs are not written (callers keep them);
//   * a ray reads its hit record only where it hit, and an inactive ray
//     only copies its state.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/shade.py binds it with ctypes and launches it on PyTorch's
// current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gi_shade.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) gi_shade_kernel(gi::Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) gi::shade(a, i);
}

}  // namespace

// The arrays of gi::Args (gi_shade.cuh), on the card; mirror: the mask's 8
// words in host memory.  Launches one thread per ray on `stream`; returns
// the cudaError_t of the launch (0 on success).
extern "C" int gi_shade(int n, int first, const uint32_t* mirror,
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
                        float* o_out, float* d_out, void* stream) {
  if (n <= 0) return 0;
  const gi::Args a = gi::make_args(
      n, first, mirror, active, accum, mask, depth, iters_out, o, o_row,
      o_col, d, d_row, d_col, r, hit, value, iters, t, normal, voxel_pos,
      accum_out, mask_out, depth_out, iters_out_out, active_out, o_out,
      d_out);
  gi_shade_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
