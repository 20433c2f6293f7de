// Kernel K3: the v1 brick-wavefront traversal, one thread per ray looping
// its own rounds.
//
// Replaces svo_raytracer_tpu/ops/brick_pallas.py::_round_kernel (the
// Pallas round kernel launched by _run_round_kernel's pl.pallas_call, one
// launch per round over rays binned by brick) and the per-ray part of its
// caller _intersect_impl.  The per-ray body is brick_round.cuh.
//
// What bounds it on Hopper: each DDA step is a dependent load of one
// occupancy word at a data-dependent address.  The L0 table (G*G words,
// 4 KB at G = 32) is copied into shared memory per block, as K2 does with
// its grid, so phase 2 reads shared memory only.  Phase 1 reads the
// brick's occupancy words (4 KB per mixed brick, ~13 MB at 1024^3: they
// fit the 50 MB L2) and a hit reads one attribute word (128 KB per brick)
// from global memory.  A voxel DDA takes one step per voxel crossed, so
// rays take many more steps than K1's coarse-refine march, and rays of
// one warp take different numbers of steps and rounds: warps diverge and
// idle lanes wait for the longest ray.  This version does nothing about
// that: no ray sorting, no persistent threads.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/brick_pallas.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brick_round.cuh"

namespace {

constexpr int MAX_G = 32;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
round_kernel(br::Scene S, int max_rounds, const float* __restrict__ origins,
             const float* __restrict__ dirs,
             const uint8_t* __restrict__ alive, int n,
             int32_t* __restrict__ hit, int32_t* __restrict__ attr,
             int32_t* __restrict__ hvox, float* __restrict__ t,
             int32_t* __restrict__ iters) {
  __shared__ int32_t l0[MAX_G * MAX_G];
  for (int w = threadIdx.x; w < S.G * S.G; w += blockDim.x) l0[w] = S.l0[w];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  S.l0 = l0;
  const br::Out r = br::trace_ray(S, origins[3 * i], origins[3 * i + 1],
                                  origins[3 * i + 2], dirs[3 * i],
                                  dirs[3 * i + 1], dirs[3 * i + 2],
                                  alive[i] != 0, max_rounds);
  hit[i] = r.hit;
  attr[i] = r.attr;
  hvox[i] = r.hvox;
  t[i] = r.t;
  iters[i] = r.iters;
}

}  // namespace

// Tables as br::Scene (G <= 32); origins: (n, 3) f32 voxel-unit ray
// origins; dirs: (n, 3) f32 directions (clamped inside); alive: (n,) u8.
// Outputs (n,) each.  Returns the cudaError_t of the launch (0 on
// success); G outside [1, 32] is refused (cudaErrorInvalidValue).
extern "C" int brick_round(const int32_t* l0, const int32_t* brick_slot,
                           const int32_t* brick_attr, const int32_t* occ,
                           const int32_t* attrs, int G, int max_rounds,
                           const float* origins, const float* dirs,
                           const uint8_t* alive, int n, int32_t* hit,
                           int32_t* attr, int32_t* hvox, float* t,
                           int32_t* iters, void* stream) {
  if (G < 1 || G > MAX_G) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const br::Scene S = {l0, brick_slot, brick_attr, occ, attrs, G, 32 * G};
  round_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                 (cudaStream_t)stream>>>(S, max_rounds, origins, dirs, alive,
                                         n, hit, attr, hvox, t, iters);
  return (int)cudaGetLastError();
}
