// CPU build of kernel RAYGEN's per-ray body (raygen.cuh), for the parity
// test tests/test_torch_kernel_source.py, which compiles this file with
// g++ -D__host__= -D__device__= -ffp-contract=off and compares it with
// ops/render_wave.py::_frame_start_plain.  No runtime path uses it: on a
// GPU the same header is compiled into raygen.cu.  The arguments are
// raygen's, in host memory, less the stream; rays are made in turn.

#include <stdint.h>

#include "raygen.cuh"

extern "C" int raygen_host(int n, int W, int H, int nbx, int gi, float fr1,
                           float fr2, const float* cam, int cam_row,
                           int cam_col, float* dirs, float* rand,
                           float* accum, float* mask, float* depth,
                           int32_t* iters, uint8_t* active) {
  const rg::Args a = {n,     W,    H,       nbx,     gi,   fr1,
                      fr2,   cam,  cam_row, cam_col, dirs, rand,
                      accum, mask, depth,   iters,   active};
  for (int i = 0; i < n; ++i) rg::raygen(a, i);
  return 0;
}
