// Kernel K1: the brick-wavefront traversal, persistent warps over ordered
// rays.
//
// Replaces svo_raytracer_tpu/ops/wavefront.py::_wf_kernel (the Pallas
// round kernel, launched by _call_kernel's pl.pallas_call): flat L0
// worlds up to G = 64 (2048^3) and paged L0 worlds of G = 128 and 256
// (4096^3, 8192^3).  Two entry points: wf_trace for explicit rays, and
// wf_trace_camera for camera-mode primaries, each derived in the lane
// from its id and the 16 camera scalars (the TPU kernel's camera mode).
// The per-ray body is wf_ray.cuh: `cross`, one brick crossing of a ray
// held in a RayState.  A third entry point, wf_ray_keys, computes the
// explicit rays' sort keys (wf_ray.cuh::ray_key).
//
// What bounds it on Hopper: each DDA step is a dependent load of a table
// word, so a lane waits on memory latency every step, and the rays of a
// warp take different numbers of steps and crossings, so lanes that
// finish wait for the warp's longest ray.  The tables of a 1024^3 world
// (~20 MB) fit the 50 MB L2; a 4096^3 heightmap world's brick words
// (~330 MB) do not, so there a step into a new brick can wait on DRAM.
// What the design does, and what measurement kept (PERF.md §6):
//   * order — the wrapper sorts explicit rays by direction octant and the
//     Morton code of their origin's brick (ray_key, then torch.sort), and
//     lane k traces ray order[k], writing its record to slot order[k]:
//     the 32 rays of a warp start in one brick heading one way and end
//     at about the same step, and dead rays sort to the tail.  This is
//     the gain: K1 alone runs bounce segments 1.4-2x faster than in frame
//     order, 1.2-1.25x on bounce 1 once the keys and the sort are counted.
//     Camera-mode primaries keep their block-major ids (a warp is one row
//     of a 32x32 pixel block);
//   * persistent warps (Aila & Laine, HPG 2009) — as many blocks as stay
//     resident; a warp takes 32 ids, one per lane, with one atomicAdd on
//     a global counter and takes the next 32 once all its lanes are done.
//     Refilling a finished lane with a further ray (from larger chunks,
//     or at a crossing boundary) measured slower on every world and in
//     both modes: a refilled ray runs on alone, out of step with the
//     warp's coherent rays;
//   * registers — __launch_bounds__(128, 7): ptxas gives all four
//     instantiations 72 registers, 28 resident warps per SM; the two
//     flat-L0 ones spill 8 bytes, the paged ones none (at 64 registers
//     they spilled up to 32 bytes); fewer registers and more warps
//     spilled more and ran slower;
//   * no shared memory — copying the flat L0 rows that phase 2 reads on
//     every step into shared memory once per block (9 KB at G = 32, 68 KB
//     at G = 64), or a paged world's page row, measured no faster at
//     G = 32, 1.7x slower at G = 64 (3 blocks per SM) and 4% slower on
//     paged primaries: the rows are L1 hits already.  Every table word is
//     read through the read-only path (__ldg).
// What is left is the latency of the brick words and, at 4096^3, of the
// page rows in DRAM.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/wavefront.py binds it with ctypes and launches it on
// PyTorch's current stream.  The id counter is scratch that the wrapper
// allocates; the entry points zero it on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wf_ray.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 7;  // resident blocks per SM ptxas is held to
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(wf::CHUNK == 32, "a warp takes one id per lane");

struct Rays {
  const float* __restrict__ origins;  // (n, 3) voxel units
  const float* __restrict__ dirs;     // (n, 3)
  const uint8_t* __restrict__ alive;  // (n,)
  const int64_t* __restrict__ order;  // (n,) lane k traces order[k]; or null
  wf::Camera cam;
};

struct Records {
  int32_t* status;
  float* t;
  int32_t* cell;
  int32_t* widx;
  int32_t* iters;
};

// Starts a lane on id k: returns the record slot of its ray, or -1 if the
// ray is dead (its miss record is written at once).
template <bool CAMERA>
__device__ inline int begin(const Rays& R, int k, wf::RayState* s,
                            const Records& out) {
  if (CAMERA) {
    *s = wf::start_camera_ray(R.cam, k);
    return k;
  }
  const int r = R.order ? (int)R.order[k] : k;
  if (!R.alive[r]) {
    wf::store(wf::miss_record(), r, out.status, out.t, out.cell, out.widx,
              out.iters);
    return -1;
  }
  const float* o = R.origins + 3 * (size_t)r;
  const float* d = R.dirs + 3 * (size_t)r;
  *s = wf::start_ray(o[0], o[1], o[2], d[0], d[1], d[2]);
  return r;
}

// A warp takes 32 ids with one atomicAdd on the global counter; lane i
// walks the crossings of id base + i's ray and writes its record, and the
// warp takes the next 32 ids once every lane is done.
template <bool CAMERA, bool PAGED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wf_trace_kernel(wf::Tables T, Rays R, int n, int* __restrict__ counter,
                Records out) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, wf::CHUNK);
    base = __shfl_sync(FULL, base, 0);
    if (base >= n) break;
    wf::RayState s;
    const int slot = base + lane < n ? begin<CAMERA>(R, base + lane, &s, out)
                                     : -1;
    if (slot >= 0) {
      wf::RayOut r;
      while (!wf::cross<PAGED>(T, s, &r)) {
      }
      wf::store(r, slot, out.status, out.t, out.cell, out.widx, out.iters);
    }
  }
}

__global__ void __launch_bounds__(256)
ray_key_kernel(const float* __restrict__ origins,
               const float* __restrict__ dirs,
               const uint8_t* __restrict__ alive, int n, int G,
               int32_t* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  keys[i] = wf::ray_key(origins[3 * i], origins[3 * i + 1],
                        origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1],
                        dirs[3 * i + 2], alive[i] != 0, G);
}

using KernelFn = void (*)(wf::Tables, Rays, int, int*, Records);

template <bool CAMERA>
KernelFn pick(const wf::Tables& T) {
  return T.pages > 0 ? wf_trace_kernel<CAMERA, true>
                     : wf_trace_kernel<CAMERA, false>;
}

// Resident blocks of `kern` per SM and the SM count; the last answer is
// kept per kernel.
cudaError_t resident(KernelFn kern, int* per_sm, int* sms) {
  struct Entry {
    KernelFn kern;
    int dev, per_sm, sms;
  };
  static Entry cache[4] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Entry* slot = nullptr;
  for (Entry& c : cache) {
    if (c.kern == kern || c.kern == nullptr) {
      slot = &c;
      break;
    }
  }
  if (slot && slot->kern == kern && slot->dev == dev) {
    *per_sm = slot->per_sm;
    *sms = slot->sms;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, THREADS, 0);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (slot) *slot = {kern, dev, *per_sm, *sms};
  return cudaSuccess;
}

// Launches the grid over n ids: the resident blocks, or fewer when n ids
// fill fewer (32 ids per warp), after zeroing the id counter on the same
// stream.
int launch(KernelFn kern, const wf::Tables& T, const Rays& R, int n,
           int* counter, const Records& out, cudaStream_t stream) {
  if (n <= 0) return 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = resident(kern, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const int per_block = THREADS / 32 * wf::CHUNK;
  const int fill = (n + per_block - 1) / per_block;
  const int blocks = per_sm * sms < fill ? per_sm * sms : fill;
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, THREADS, 0, stream>>>(T, R, n, counter, out);
  return (int)cudaGetLastError();
}

}  // namespace

// origins: (n, 3) f32 voxel-unit ray origins; dirs: (n, 3) f32 directions
// (clamped inside); alive: (n,) u8; order: (n,) i64 permutation (lane k
// traces ray order[k]) or null for frame order; counter: one int32 of
// scratch.  Outputs (n,) each, written at the rays' own slots.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int wf_trace(const int32_t* l0_occ, const int32_t* l0_mixed,
                        const int32_t* l0_sc, const int32_t* brick_slot,
                        const int32_t* occ_words, const int32_t* sc_words,
                        int G, int l0_coarse_base, int zw, int pages,
                        const float* origins, const float* dirs,
                        const uint8_t* alive, const int64_t* order, int n,
                        int* counter, int32_t* status, float* t,
                        int32_t* cell, int32_t* widx, int32_t* iters,
                        void* stream) {
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  const Rays R = {origins, dirs, alive, order, {}};
  const Records out = {status, t, cell, widx, iters};
  return launch(pick<false>(T), T, R, n, counter, out,
                (cudaStream_t)stream);
}

// Camera mode: the n primaries of a W x H frame (nbx > 0: block-major
// ids, nbx 32-pixel blocks per row) from cam, 16 f32 scalars on the card;
// world_size scales the origin to voxel units.  Outputs as wf_trace.
extern "C" int wf_trace_camera(const int32_t* l0_occ, const int32_t* l0_mixed,
                               const int32_t* l0_sc,
                               const int32_t* brick_slot,
                               const int32_t* occ_words,
                               const int32_t* sc_words, int G,
                               int l0_coarse_base, int zw, int pages,
                               const float* cam, int W, int H, int nbx,
                               int world_size, int n, int* counter,
                               int32_t* status, float* t, int32_t* cell,
                               int32_t* widx, int32_t* iters, void* stream) {
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  Rays R = {};
  R.cam = {cam, W, H, nbx, (float)world_size};
  const Records out = {status, t, cell, widx, iters};
  return launch(pick<true>(T), T, R, n, counter, out, (cudaStream_t)stream);
}

// The sort keys of n explicit rays (wf_ray.cuh::ray_key) into keys (n,)
// i32, for a world of G bricks per edge.
extern "C" int wf_ray_keys(const float* origins, const float* dirs,
                           const uint8_t* alive, int n, int G, int32_t* keys,
                           void* stream) {
  if (n <= 0) return 0;
  ray_key_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      origins, dirs, alive, n, G, keys);
  return (int)cudaGetLastError();
}

// The persistent launch of a world's layout: info[0] resident blocks per
// SM, info[1] SMs, info[2] threads per block (camera selects the
// camera-mode kernel).  Returns the cudaError_t of the occupancy query.
extern "C" int wf_launch_info(int G, int l0_coarse_base, int zw, int pages,
                              int camera, int* info) {
  const wf::Tables T = wf::make_tables(nullptr, nullptr, nullptr, nullptr,
                                       nullptr, nullptr, G, l0_coarse_base,
                                       zw, pages);
  const cudaError_t e = resident(camera ? pick<true>(T) : pick<false>(T),
                                 &info[0], &info[1]);
  info[2] = THREADS;
  return (int)e;
}
