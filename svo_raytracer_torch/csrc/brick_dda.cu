// Kernel K2: the coarse occupancy-grid DDA, one thread per ray.
//
// Replaces svo_raytracer_tpu/ops/brick_dda.py::_dda_kernel (the Pallas
// kernel launched by coarse_dda's pl.pallas_call), which keeps the whole
// grid in VMEM.  The per-ray body is brick_dda.cuh.
//
// What bounds it on Hopper: each step is a load of one occupancy word at
// a data-dependent address.  The table is small (G^2 * ceil(G/32) words:
// 4 KB at G = 32, 32 KB at G = 64), so each block first copies all of it
// into shared memory and the march then reads shared memory only; what
// is left is the per-step integer and float work of up to 3G steps, and
// warp divergence between rays that stop at different steps.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/brick_dda.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brick_dda.cuh"

namespace {

constexpr int MAX_WORDS = 64 * 64 * 2;  // G <= 64: 32 KB of static shared

__global__ void __launch_bounds__(256)
dda_kernel(const int32_t* __restrict__ table, int G, int W, int max_steps,
           const float* __restrict__ origins, const float* __restrict__ dirs,
           const uint8_t* __restrict__ active, int n,
           int32_t* __restrict__ hit, float* __restrict__ t,
           int32_t* __restrict__ cell, int32_t* __restrict__ steps) {
  __shared__ int32_t tab[MAX_WORDS];
  const int n_words = G * G * W;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) tab[w] = table[w];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const dda::Out r = dda::march(
      tab, G, W, max_steps, origins[3 * i], origins[3 * i + 1],
      origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2],
      active[i] != 0);
  hit[i] = r.hit;
  t[i] = r.t;
  cell[3 * i] = r.cx;
  cell[3 * i + 1] = r.cy;
  cell[3 * i + 2] = r.cz;
  steps[i] = r.steps;
}

}  // namespace

// table: >= G*G*W i32 words; origins, dirs: (n, 3) f32 grid units;
// active: (n,) u8.  Outputs hit, t, steps (n,) and cell (n, 3).  Returns
// the cudaError_t of the launch (0 on success); G > 64 is refused
// (cudaErrorInvalidValue).
extern "C" int dda_march(const int32_t* table, int G, int max_steps,
                         const float* origins, const float* dirs,
                         const uint8_t* active, int n, int32_t* hit,
                         float* t, int32_t* cell, int32_t* steps,
                         void* stream) {
  const int W = (G + 31) / 32;
  if (G < 1 || G * G * W > MAX_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  dda_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, G, W, max_steps, origins, dirs, active, n, hit, t, cell, steps);
  return (int)cudaGetLastError();
}
