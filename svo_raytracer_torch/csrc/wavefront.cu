// Kernel K1: the brick-wavefront traversal, one thread per ray.
//
// Replaces svo_raytracer_tpu/ops/wavefront.py::_wf_kernel (the Pallas
// round kernel, launched by _call_kernel's pl.pallas_call): flat L0
// worlds up to G = 64 (2048^3) and paged L0 worlds of G = 128 and 256
// (4096^3, 8192^3).  Two entry points: wf_trace for explicit rays, and
// wf_trace_camera for camera-mode primaries, each derived in the thread
// from its id and the 16 camera scalars (the TPU kernel's camera mode),
// so a 1080p primary segment reads no origin or direction arrays (~50 MB
// less traffic).  The per-ray body is wf_ray.cuh.
//
// What bounds it on Hopper: each DDA step is a dependent load of a table
// word (L0 coarse/byte words or a page's rows, a brick's coarse and
// byte-cell words), so a thread waits on memory latency every step.  The
// tables of a 1024^3 world (~4.5 KB per mixed brick plus the L0 rows,
// ~20 MB) fit the 50 MB L2; a 4096^3 heightmap world's brick words (~70k
// slots x 4.5 KB, ~330 MB) do not, so there each step into a new brick
// can wait on DRAM.  (The attribute table is read by the decode after
// K1, not by K1.)  Rays of one warp take
// different numbers of steps and crossings, so warps diverge and idle
// lanes wait for the longest ray.  This version does nothing about
// either: no ray sorting, no persistent threads, no staging in shared
// memory; what the DRAM latency costs at 4096^3 is measured, not tuned.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/wavefront.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wf_ray.cuh"

namespace {

__global__ void __launch_bounds__(128)
wf_trace_kernel(wf::Tables T, const float* __restrict__ origins,
                const float* __restrict__ dirs,
                const uint8_t* __restrict__ alive, int n,
                int32_t* __restrict__ status, float* __restrict__ t,
                int32_t* __restrict__ cell, int32_t* __restrict__ widx,
                int32_t* __restrict__ iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const wf::RayOut r = wf::trace_ray(
      T, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
      dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], alive[i] != 0);
  wf::store(r, i, status, t, cell, widx, iters);
}

__global__ void __launch_bounds__(128)
wf_camera_kernel(wf::Tables T, wf::Camera cam, int n,
                 int32_t* __restrict__ status, float* __restrict__ t,
                 int32_t* __restrict__ cell, int32_t* __restrict__ widx,
                 int32_t* __restrict__ iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  wf::store(wf::trace_camera_ray(T, cam, i), i, status, t, cell, widx,
            iters);
}

constexpr int THREADS = 128;

}  // namespace

// origins: (n, 3) f32 voxel-unit ray origins; dirs: (n, 3) f32 directions
// (clamped inside); alive: (n,) u8.  Outputs (n,) each.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wf_trace(const int32_t* l0_occ, const int32_t* l0_mixed,
                        const int32_t* l0_sc, const int32_t* brick_slot,
                        const int32_t* occ_words, const int32_t* sc_words,
                        int G, int l0_coarse_base, int zw, int pages,
                        const float* origins,
                        const float* dirs, const uint8_t* alive, int n,
                        int32_t* status, float* t, int32_t* cell,
                        int32_t* widx, int32_t* iters, void* stream) {
  if (n <= 0) return 0;
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  wf_trace_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(T, origins, dirs, alive, n,
                                            status, t, cell, widx, iters);
  return (int)cudaGetLastError();
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
                               int world_size, int n, int32_t* status,
                               float* t, int32_t* cell, int32_t* widx,
                               int32_t* iters, void* stream) {
  if (n <= 0) return 0;
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  const wf::Camera C = {cam, W, H, nbx, (float)world_size};
  wf_camera_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(T, C, n, status, t, cell, widx,
                                             iters);
  return (int)cudaGetLastError();
}
