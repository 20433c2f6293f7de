// Kernel K3: the v1 brick-wavefront traversal, one thread per ray looping
// its own rounds.
//
// Replaces svo_raytracer_tpu/ops/brick_pallas.py::_round_kernel (the
// Pallas round kernel launched by _run_round_kernel's pl.pallas_call, one
// launch per round over rays binned by brick) and the per-ray part of its
// caller _intersect_impl.  The per-ray body is brick_round.cuh.
//
// What bounds it on Hopper: each DDA step is a dependent load of one
// occupancy word at a data-dependent address.  Phase 1 reads the brick's
// occupancy words (4 KB per mixed brick, ~13 MB at 1024^3: they fit the
// 50 MB L2) and a hit reads one attribute word (128 KB per brick); phase
// 2 reads the L0 table (G*G words, 4 KB at G = 32).  A voxel DDA takes one
// step per voxel crossed, so rays take many more steps than K1's
// coarse-refine march, and rays of one warp take different numbers of
// steps and rounds: warps diverge and idle lanes wait for the longest ray.
// What the design does, and what measurement kept (PERF.md §6):
//   * order — the caller passes the permutation the rays are traced in:
//     thread k traces ray order[k] and writes its record to that ray's
//     slot.  A render traces both segments in 8x4 pixel tiles
//     (traverse.tile_order), so a warp's rays start from one patch of the
//     image, walk the same bricks and take similar step counts: 6% faster
//     on primaries and 14% on shadow rays than row order.  The TPU's
//     binning by brick before every round would need a sort per round;
//   * tables — every table, L0 included, is read through the read-only
//     path (__ldg): the 4 KB L0 stays in L1 and no block copies it
//     (copying it into shared memory per block measured 1-2% slower);
//   * every step loads its column's word: keeping the word in a register
//     across steps along z measured 2-8% slower, a grid of the resident
//     blocks taking rays by a grid stride 17-31% slower, and a minimum of
//     resident blocks in __launch_bounds__ 0.3-2% slower.
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

struct Rays {
  const float* __restrict__ origins;
  const float* __restrict__ dirs;
  const uint8_t* __restrict__ alive;
  const int64_t* __restrict__ order;  // thread k traces order[k]; or null
  int n;
  uint8_t* __restrict__ hit;  // 0 or 1: the bytes of a bool tensor
  int32_t* __restrict__ attr;
  int32_t* __restrict__ hvox;
  float* __restrict__ t;
  int32_t* __restrict__ iters;
};

__global__ void __launch_bounds__(THREADS)
round_kernel(br::Scene S, int max_rounds, Rays R) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= R.n) return;
  const int i = R.order ? (int)R.order[k] : k;
  const float* o = R.origins + 3 * (size_t)i;
  const float* d = R.dirs + 3 * (size_t)i;
  const br::Out r = br::trace_ray(S, o[0], o[1], o[2], d[0], d[1], d[2],
                                  R.alive[i] != 0, max_rounds);
  R.hit[i] = (uint8_t)r.hit;
  R.attr[i] = r.attr;
  R.hvox[i] = r.hvox;
  R.t[i] = r.t;
  R.iters[i] = r.iters;
}

}  // namespace

// Tables as br::Scene (G <= 32); origins: (n, 3) f32 voxel-unit ray
// origins; dirs: (n, 3) f32 directions (clamped inside); alive: (n,) u8;
// order: (n,) i64 permutation the rays are traced in, or null for ray
// order.  Outputs (n,) each, at the rays' own slots; hit as u8 0 or 1.
// Returns the cudaError_t of the launch (0 on success); G outside [1, 32]
// is refused (cudaErrorInvalidValue).
extern "C" int brick_round(const int32_t* l0, const int32_t* brick_slot,
                           const int32_t* brick_attr, const int32_t* occ,
                           const int32_t* attrs, int G, int max_rounds,
                           const float* origins, const float* dirs,
                           const uint8_t* alive, const int64_t* order, int n,
                           uint8_t* hit, int32_t* attr, int32_t* hvox,
                           float* t, int32_t* iters, void* stream) {
  if (G < 1 || G > MAX_G) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const br::Scene S = {l0, brick_slot, brick_attr, occ, attrs, G, 32 * G};
  const Rays R = {origins, dirs, alive, order, n, hit, attr, hvox, t, iters};
  round_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                 (cudaStream_t)stream>>>(S, max_rounds, R);
  return (int)cudaGetLastError();
}
