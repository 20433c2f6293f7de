// Kernel KE: the ESVO octree traversal, one ray per thread.
//
// Replaces the XLA while_loop of svo_raytracer_tpu/ops/traverse.py::
// intersect_octree (:415-423 over _make_step, :182-322); the JAX package
// has no Pallas kernel for it.  The per-ray body is esvo_ray.cuh.
//
// What bounds it on Hopper: every step is one dependent load of a packed
// node word (4 B) at a data-dependent address, so a thread waits on
// memory latency each step.  A 1024^3 heightmap octree's table (64 MB)
// does not fit the 50 MB L2, but the upper levels that every ray walks
// through do.  Rays of one warp take different numbers of steps and
// different paths, so warps diverge and idle lanes wait for the longest
// ray.  What the design does, and what measurement kept (PERF.md §6):
//   * order — the caller passes the permutation the rays are traced in:
//     thread k traces ray order[k] and writes its record to that ray's
//     slot.  A render traces every segment in 8x4 pixel tiles
//     (traverse.tile_order, one cached permutation per image size), so a
//     warp's rays start from one compact patch of the image: primaries
//     and mode-2 shadow rays ran ~15% faster than in row order.  Sorting
//     the rays by a key (direction octant over the Morton code of the
//     origin's octree cell, K1's scheme) made the kernel alone up to 10%
//     faster on bounce segments, but its key kernel and torch.sort took
//     0.17-0.22 ms a segment, more than they saved on every segment;
//   * bins — on a cone-traced (GI bounce) segment a block regroups its
//     128 rays by octant, rays that retire at once last, with a counting
//     sort in shared memory before tracing, so a warp's rays head one way
//     (4% faster on the bounce segment; 4% slower on primaries and shadow
//     rays, which already share a direction, so only there);
//   * the stack — the node-only, never-cleared stack of esvo_ray.cuh in
//     local memory (96 B of stack frame, where node and word arrays
//     cleared per ray took 184 B); stacks in shared memory measured
//     slower;
//   * registers — __launch_bounds__(128, 12): 12 resident blocks (48
//     warps) per SM; persistent warps that take 32 ids per atomicAdd
//     (K1's scheme) measured 2-7% slower.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/traverse.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "esvo_ray.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 12;  // resident blocks per SM ptxas is held to
constexpr int BINS = esvo::DEAD_BIN + 1;

struct Args {
  const int32_t* __restrict__ packed;
  const float* __restrict__ origins;
  const float* __restrict__ dirs;
  const uint8_t* __restrict__ active;
  const int64_t* __restrict__ order;  // thread k traces order[k]; or null
  int n, max_depth, cone, max_it, stack_depth;
  float* __restrict__ f_out;
  int32_t* __restrict__ i_out;
};

__device__ inline int ray_of(const Args& a, int k) {
  return a.order ? (int)a.order[k] : k;
}

__device__ inline void trace_one(const Args& a, int i) {
  const float* o = a.origins + 3 * (size_t)i;
  const float* d = a.dirs + 3 * (size_t)i;
  const esvo::State s = esvo::trace_ray(
      a.packed, o[0], o[1], o[2], d[0], d[1], d[2], a.active[i] != 0,
      a.max_depth, a.cone != 0, a.max_it, a.stack_depth);
  const int n = a.n;
  // float fields: t_min, t_max, px, py, pz, scale_exp2 (planes of n)
  a.f_out[i] = s.t_min;
  a.f_out[n + i] = s.t_max;
  a.f_out[2 * n + i] = s.px;
  a.f_out[3 * n + i] = s.py;
  a.f_out[4 * n + i] = s.pz;
  a.f_out[5 * n + i] = s.scale_exp2;
  // int fields: idx, parent, scale, iters, done
  a.i_out[i] = s.idx;
  a.i_out[n + i] = s.parent;
  a.i_out[2 * n + i] = s.scale;
  a.i_out[3 * n + i] = s.iters;
  a.i_out[4 * n + i] = s.done;
}

// Block b takes ids [128 b, 128 b + 128).  BIN: the block's rays are
// regrouped by esvo::ray_bin (a counting sort in shared memory; within a
// bin the order is that of the atomics), then thread t traces the t-th.
template <bool BIN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
esvo_trace_kernel(Args a) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (!BIN) {
    if (k < a.n) trace_one(a, ray_of(a, k));
    return;
  }
  __shared__ int ids[THREADS];
  __shared__ int count[BINS], start[BINS];
  if (threadIdx.x < BINS) count[threadIdx.x] = 0;
  __syncthreads();
  int i = 0, bin = 0, pos = 0;
  if (k < a.n) {
    i = ray_of(a, k);
    const float* o = a.origins + 3 * (size_t)i;
    const float* d = a.dirs + 3 * (size_t)i;
    bin = esvo::ray_bin(o[0], o[1], o[2], d[0], d[1], d[2],
                        a.active[i] != 0);
    pos = atomicAdd(&count[bin], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int b = 0; b < BINS; ++b) {
      start[b] = sum;
      sum += count[b];
    }
  }
  __syncthreads();
  if (k < a.n) ids[start[bin] + pos] = i;
  __syncthreads();
  if (k < a.n) trace_one(a, ids[threadIdx.x]);
}

template <bool BIN>
int launch(const int32_t* packed, const float* origins, const float* dirs,
           const uint8_t* active, const int64_t* order, int n,
           int max_depth, int cone, int max_it, int stack_depth,
           float* f_out, int32_t* i_out, void* stream) {
  if (n <= 0) return 0;
  const Args a = {packed, origins, dirs,   active,      order, n,
                  max_depth, cone, max_it, stack_depth, f_out, i_out};
  esvo_trace_kernel<BIN><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// packed: (n_nodes,) i32 words; origins, dirs: (n, 3) f32 world units;
// active: (n,) u8; order: (n,) i64 permutation, or null for ray order.
// f_out: (6, n) f32, i_out: (5, n) i32 (field order in trace_one).
// Returns the cudaError_t of the launch (0 on success).  esvo_trace runs
// the plain schedule, esvo_trace_binned the binned one (the wrapper's
// choice for cone-traced segments).
extern "C" int esvo_trace(const int32_t* packed, const float* origins,
                          const float* dirs, const uint8_t* active,
                          const int64_t* order, int n, int max_depth,
                          int cone, int max_it, int stack_depth,
                          float* f_out, int32_t* i_out, void* stream) {
  return launch<false>(packed, origins, dirs, active, order, n, max_depth,
                       cone, max_it, stack_depth, f_out, i_out, stream);
}

extern "C" int esvo_trace_binned(const int32_t* packed, const float* origins,
                                 const float* dirs, const uint8_t* active,
                                 const int64_t* order, int n, int max_depth,
                                 int cone, int max_it, int stack_depth,
                                 float* f_out, int32_t* i_out, void* stream) {
  return launch<true>(packed, origins, dirs, active, order, n, max_depth,
                      cone, max_it, stack_depth, f_out, i_out, stream);
}
