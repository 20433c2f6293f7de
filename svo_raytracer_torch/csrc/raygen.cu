// Kernel RAYGEN: a frame's assembly, everything the frame's segments read
// before the first one, one thread per ray.
//
// Replaces no TPU kernel: the JAX package leaves the frame's rays, its
// per-pixel random and mode 0's initial state
// (svo_raytracer_tpu/ops/render_wave.py::_frame_rays and _gi_init) to
// XLA, which fuses its elementwise glue.  Eager PyTorch ran it as ~100
// kernels a mode-0 frame (ops/render_wave.py::_frame_start_plain, the
// plain version); this runs it in registers.  The per-ray body is
// raygen.cuh.
//
// What bounds it on Hopper: device-memory writes.  A ray reads nothing
// but the 60 B camera, shared by all (read through its strides: the
// callers' uniform is often column-major), and writes its unit direction (12
// B) and, in render mode 0, its random 4, accum 12, mask 12, depth 4,
// iters 4 and active 1: 49 B a ray, 12 B in modes 1-3.  Its arithmetic
// (three sinf, two divisions and a square root a ray) is far below that.
// What the design does:
//   * one launch, no copies: one thread a ray, neighbouring threads on
//     neighbouring rows, so the stores coalesce; the image size, the
//     order and the frame's two random offsets arrive by value;
//   * the mode is a flag of its arguments: modes 1-3 write only the
//     directions.
//
// Built by ops/kernel_build.py with nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -fmad=false into a shared library with a plain C entry
// point; ops/render_wave.py binds it with ctypes and launches it on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raygen.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) raygen_kernel(rg::Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) rg::raygen(a, i);
}

}  // namespace

// The arrays of rg::Args (raygen.cuh), on the card.  Launches one thread
// per ray on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int raygen(int n, int W, int H, int nbx, int gi, float fr1,
                      float fr2, const float* cam, int cam_row, int cam_col,
                      float* dirs, float* rand, float* accum, float* mask,
                      float* depth, int32_t* iters, uint8_t* active,
                      void* stream) {
  if (n <= 0) return 0;
  const rg::Args a = {n,     W,    H,       nbx,     gi,   fr1,
                      fr2,   cam,  cam_row, cam_col, dirs, rand,
                      accum, mask, depth,   iters,   active};
  raygen_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
