// Kernel KE: the ESVO octree traversal, one thread per ray.
//
// Replaces the XLA while_loop of svo_raytracer_tpu/ops/traverse.py::
// intersect_octree (:415-423 over _make_step, :182-322); the JAX package
// has no Pallas kernel for it.  The per-ray body is esvo_ray.cuh.
//
// What bounds it on Hopper: every step is one dependent load of a packed
// node word (4 B) at a data-dependent address, so a thread waits on
// memory latency each step.  A 1024^3 heightmap octree's table (tens of
// millions of words) does not fit the 50 MB L2, but the upper levels that
// every ray walks through do.  Rays of one warp take different numbers
// of steps, so warps diverge and idle lanes wait for the longest ray;
// the 2 x 23-entry stack lives in local memory.  This version does
// nothing about either: no ray sorting, no persistent threads, no stack
// in shared memory.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/traverse.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "esvo_ray.cuh"

namespace {

__global__ void __launch_bounds__(128)
esvo_trace_kernel(const int32_t* __restrict__ packed,
                  const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const uint8_t* __restrict__ active, int n, int max_depth,
                  int cone, int max_it, int stack_depth,
                  float* __restrict__ f_out, int32_t* __restrict__ i_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const esvo::State s = esvo::trace_ray(
      packed, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
      dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], active[i] != 0,
      max_depth, cone != 0, max_it, stack_depth);
  // float fields: t_min, t_max, px, py, pz, scale_exp2 (planes of n)
  f_out[i] = s.t_min;
  f_out[n + i] = s.t_max;
  f_out[2 * n + i] = s.px;
  f_out[3 * n + i] = s.py;
  f_out[4 * n + i] = s.pz;
  f_out[5 * n + i] = s.scale_exp2;
  // int fields: idx, parent, scale, iters, done
  i_out[i] = s.idx;
  i_out[n + i] = s.parent;
  i_out[2 * n + i] = s.scale;
  i_out[3 * n + i] = s.iters;
  i_out[4 * n + i] = s.done;
}

}  // namespace

// packed: (n_nodes,) i32 words; origins, dirs: (n, 3) f32 world units;
// active: (n,) u8.  f_out: (6, n) f32, i_out: (5, n) i32 (field order in
// esvo_trace_kernel).  Returns the cudaError_t of the launch (0 on success).
extern "C" int esvo_trace(const int32_t* packed, const float* origins,
                          const float* dirs, const uint8_t* active, int n,
                          int max_depth, int cone, int max_it,
                          int stack_depth, float* f_out, int32_t* i_out,
                          void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  esvo_trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      packed, origins, dirs, active, n, max_depth, cone, max_it,
      stack_depth, f_out, i_out);
  return (int)cudaGetLastError();
}
