// Kernel RAYGEN, per-ray body: the start of a frame for one pixel of the
// ray array, in block-major order (32x32-pixel blocks, pad rows below the
// image) or row-major.
//
// The same work, in the same order and with the same float32 roundings,
// as ops/render_wave.py::_frame_start_plain: the unit direction of
// _frame_rays (wf_ray.cuh's camera_pixel and camera_dir, the body that
// camera-mode K1 runs), and in render mode 0 the per-pixel random of
// ops/rng.py::pixel_rand and _render_gi's initial state (accum 0, mask 1,
// depth -1, iters 0, active).  The random takes the pixel's own row,
// also on a pad row; only the direction clamps it to the last real row.
// pixel_rand's float32(frame) * float32(0.1) and * float32(0.02) arrive
// by value.  sinf and floorf are the library's own (no fast math), as
// torch's sin and floor are on each device.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (raygen.cu) and a g++ build for the CPU parity test (raygen_host.cpp)
// include the same code; keep the float arithmetic in the plain
// version's order (no fused multiply-add).
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wf_ray.cuh"

namespace rg {

// ops/rng.py::glsl_rand's constants, float32 bits
constexpr float DOT_X = 0x1.9fac72p+3f;   // float32(12.9898)
constexpr float DOT_Y = 0x1.38ee98p+6f;   // float32(78.233)
constexpr float SCALE = 0x1.55dd18p+15f;  // float32(43758.5453)

// One frame: the image, the camera and fresh outputs, packed (B,) or
// (B, 3) rows; active is the bytes of a bool tensor.  The random and the
// accumulators are written only where `gi` is set (null otherwise).
struct Args {
  int n;           // rays: W times the 32-padded height, or W * H
  int W, H;        // image size
  int nbx;         // > 0: 32x32-pixel blocks, nbx blocks per row
  int gi;          // 1 in render mode 0
  float fr1, fr2;  // float32(frame) * float32(0.1), * float32(0.02)
  // the camera uniform (5, 3): pos, l1, l2, r1, r2, read through its
  // strides in floats
  const float* cam;
  int cam_row, cam_col;
  float* dirs;
  float* rand;
  float* accum;
  float* mask;
  float* depth;
  int32_t* iters;
  uint8_t* active;
};

// fract(sin(x * 12.9898 + y * 78.233) * 43758.5453), glsl_rand's order.
__host__ __device__ inline float glsl_rand(float x, float y) {
  const float v = sinf(x * DOT_X + y * DOT_Y) * SCALE;
  return v - floorf(v);
}

__host__ __device__ inline void raygen(const Args& a, int i) {
  float c15[15];  // the camera's 15 scalars, in cam16's order
  for (int k = 0; k < 15; ++k) {
    c15[k] = a.cam[k / 3 * a.cam_row + k % 3 * a.cam_col];
  }
  const wf::Camera cam = {c15, a.W, a.H, a.nbx, 0.0f};
  int pxi, pyi;
  wf::camera_pixel(cam, i, &pxi, &pyi);
  float d[3];
  wf::camera_dir(cam, pxi, pyi, d);
  const size_t row = 3 * (size_t)i;
  for (int c = 0; c < 3; ++c) a.dirs[row + c] = d[c];
  if (!a.gi) return;
  const float px = (float)pxi, py = (float)pyi;
  a.rand[i] = glsl_rand(px + glsl_rand(px, a.fr1),
                        py + glsl_rand(py, a.fr2));
  for (int c = 0; c < 3; ++c) {
    a.accum[row + c] = 0.0f;
    a.mask[row + c] = 1.0f;
  }
  a.depth[i] = -1.0f;
  a.iters[i] = 0;
  a.active[i] = 1;
}

}  // namespace rg
