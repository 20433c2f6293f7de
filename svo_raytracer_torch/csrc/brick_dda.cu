// Kernel K2: the coarse occupancy-grid DDA, one thread per ray.
//
// Replaces svo_raytracer_tpu/ops/brick_dda.py::_dda_kernel (the Pallas
// kernel launched by coarse_dda's pl.pallas_call), which keeps the whole
// grid in VMEM.  The per-ray body is brick_dda.cuh.
//
// What bounds it on Hopper: each step is a load of one occupancy word at
// a data-dependent address, and rays take few steps (0-3 a ray on the
// 1080p skip frames), so the rays' own bytes (24 in, 21 out) and the
// table's copy into shared memory weigh as much as the march.  What the
// design does, and what measurement kept (PERF.md §6):
//   * the table — copied into dynamic shared memory sized to its G^2 * W
//     words (4 KB at G = 32, 32 KB at G = 64), once per resident block:
//     the grid is the blocks that fit on the card, and each block takes
//     rays by a static grid stride.  A grid of one id per thread, each
//     block copying the table, took 1.2-1.4x as long at G = 64 (8,100
//     copies of 32 KB a launch); loading each thread's first ray before
//     the copy, or reading the table unstaged through the read-only
//     path, measured within 3% either way;
//   * ray order — thread k traces ray k.  K2 is bound by the rays' own
//     bytes, and tracing them through the render's 8x4 pixel tiles (the
//     permutation KE takes) made a warp's loads four runs of eight and
//     took 14-29% longer than ray order, so K2 takes no permutation;
//   * no wrapper kernel — the active mask and hit are the bytes of bool
//     tensors, and a direction row shared by every ray (a shadow
//     segment's sun) is read in place, so the wrapper launches K2 alone.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/brick_dda.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "brick_dda.cuh"

namespace {

constexpr int MAX_G = 64;
constexpr int THREADS = 256;

struct Args {
  const int32_t* __restrict__ table;
  int G, W, max_steps;
  const float* __restrict__ origins;
  const float* __restrict__ dirs;
  int d_stride;  // floats from one ray's direction to the next: 3 or 0
  const uint8_t* __restrict__ active;  // or null: every ray active
  int n;
  uint8_t* __restrict__ hit;
  float* __restrict__ t;
  int32_t* __restrict__ cell;
  int32_t* __restrict__ steps;
};

__global__ void __launch_bounds__(THREADS) dda_kernel(Args a) {
  extern __shared__ int32_t tab[];
  const int n_words = a.G * a.G * a.W;
  for (int w = threadIdx.x; w < n_words; w += THREADS)
    tab[w] = __ldg(a.table + w);
  __syncthreads();
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < a.n;
       i += gridDim.x * THREADS) {
    const float* o = a.origins + 3 * (size_t)i;
    const float* d = a.dirs + (size_t)a.d_stride * i;
    const dda::Out r = dda::march(tab, a.G, a.W, a.max_steps, o[0], o[1],
                                  o[2], d[0], d[1], d[2],
                                  a.active ? a.active[i] != 0 : true);
    a.hit[i] = (uint8_t)r.hit;
    a.t[i] = r.t;
    a.cell[3 * i] = r.cx;
    a.cell[3 * i + 1] = r.cy;
    a.cell[3 * i + 2] = r.cz;
    a.steps[i] = r.steps;
  }
}

// The resident blocks of dda_kernel with `smem` bytes of table on the
// current card; the last answer is kept.
cudaError_t resident(int smem, int* blocks) {
  static int cached_dev = -1, cached_smem = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dda_kernel,
                                                      THREADS, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_blocks = per_sm * sms;
  }
  *blocks = cached_blocks;
  return cudaSuccess;
}

}  // namespace

// table: >= G*G*W i32 words; origins, dirs: (n, 3) f32 grid units, the
// directions' rows d_stride floats apart (3, or 0 for one row shared by
// every ray); active: (n,) u8, or null for every ray.  Outputs: hit (n,)
// u8 (0 or 1, the bytes of a bool tensor), t, steps (n,) and cell (n, 3).  Launches the resident blocks, or fewer
// when n rays fill fewer.  Returns the cudaError_t of the launch (0 on
// success); G outside [1, 64] is refused (cudaErrorInvalidValue).
extern "C" int dda_march(const int32_t* table, int G, int max_steps,
                         const float* origins, const float* dirs,
                         int d_stride,
                         const uint8_t* active, int n,
                         uint8_t* hit, float* t, int32_t* cell,
                         int32_t* steps, void* stream) {
  if (G < 1 || G > MAX_G) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int W = (G + 31) / 32;
  const Args a = {table,  G, W,   max_steps, origins, dirs, d_stride,
                  active, n, hit, t,         cell,    steps};
  const int smem = G * G * W * (int)sizeof(int32_t);
  int blocks = 0;
  const cudaError_t e = resident(smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  const int fill = (n + THREADS - 1) / THREADS;
  dda_kernel<<<fill < blocks ? fill : blocks, THREADS, smem,
               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
