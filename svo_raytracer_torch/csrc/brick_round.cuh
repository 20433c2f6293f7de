// Kernel K3, per-ray body: the v1 brick-wavefront traversal of one ray,
// round after round.
//
// Replaces the per-lane arithmetic of svo_raytracer_tpu/ops/
// brick_pallas.py::_round_kernel (:149-248) with its DDA `_dda_vec`
// (:67-146), and what `_intersect_impl`'s `round_body` (:306-415) does
// around each launch for one ray.  On the TPU each round is a launch over
// rays binned by brick, so that each tile's brick words can be pipelined
// into VMEM; here a thread can read any brick, so it loops its own rounds:
//
//   * phase 1 (the ray is in mixed brick `slot`): a voxel DDA through the
//     brick's 32^3 occupancy bits, at most 100 steps;
//   * phase 2, from just past the brick's exit (EXIT_EPS): a DDA of the
//     L0 brick grid (G <= 32, cell 32) to the next occupied brick, at most
//     3G + 4 steps;
//   * the classification of a stop: a uniform-solid brick is a hit at its
//     entry voxel; otherwise the ray enters that brick (mixed or not) in
//     the next round.  A phase-1 hit fetches the voxel's attribute word.
//
// A ray still pending after max_rounds rounds is a miss, as in JAX.  JAX
// rays that overflow a bin's padding lose a round; here no ray waits, so
// JAX may run out of rounds where this does not.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (brick_round.cu) and a g++ build for the CPU parity test
// (brick_round_host.cpp) include the same code.  The plain PyTorch version
// is ops/brick_pallas.py::trace_plain; keep the float arithmetic in the
// same order (no fused multiply-add), with true divisions.
#pragma once

#include <math.h>
#include <stdint.h>

#include "fp.cuh"
#include "wf_ray.cuh"

namespace br {

constexpr float EXIT_EPS = 1e-2f;  // brick_pallas._EXIT_EPS (not 1/1024)
constexpr int INNER_STEPS = 100;   // phase-1 step budget
constexpr int BRICK_WORDS = 32768;

struct Scene {
  const int32_t* l0;          // (G*G,) z-packed brick occupancy, word x*G + y
  const int32_t* brick_slot;  // (G^3,) mixed slot or -1
  const int32_t* brick_attr;  // (G^3,) uniform attribute word
  const int32_t* occ;         // (n_mixed, 1024) voxel bits, word x*32 + y
  const int32_t* attrs;       // (n_mixed, 32768) voxel attribute words
  int G;                      // bricks per edge, <= 32
  int ws;                     // world size in voxels (32 G)
};

struct Out {
  int32_t hit;
  int32_t attr;  // attribute word of the hit voxel
  int32_t hvox;  // hit voxel (x*ws + y)*ws + z
  float t;       // hit distance in voxel units (0 on a miss)
  int32_t iters; // DDA steps over all rounds
};

struct Dda {
  bool hit;
  int ix, iy, iz;  // the hit cell, or the cell the march stopped in
  float t;         // entry t of the hit cell, else the last crossing
  bool inside;     // still inside the grid (budget spent, not exited)
  int steps;
};

// The z-packed occupancy bits of an n^3 grid in device memory: bit z of
// word x*n + y, read through the read-only path (wf::ldg).
struct Bits {
  const int32_t* words;
  int n;
  __host__ __device__ bool operator()(int x, int y, int z) const {
    return ((wf::ldg(words + x * n + y) >> z) & 1u) != 0;
  }
};

// Masked DDA over an n^3 grid of `cell`-edge cells in [0, n*cell]^3
// (brick_pallas.py::_dda_vec).  Cell indices truncate toward zero.  The
// TPU runs max_steps masked steps; a ray stops changing once it hits or
// leaves the grid, so this loop stops there.
__host__ __device__ inline Dda dda_vec(float px, float py, float pz,
                                       float dxc, float dyc, float dzc,
                                       float inv_x, float inv_y, float inv_z,
                                       int n, float cell, const Bits& probe,
                                       int max_steps) {
  const float gf = (float)n * cell;
  const float t1x = (0.0f - px) * inv_x, t2x = (gf - px) * inv_x;
  const float t1y = (0.0f - py) * inv_y, t2y = (gf - py) * inv_y;
  const float t1z = (0.0f - pz) * inv_z, t2z = (gf - pz) * inv_z;
  const float t_ent = fp::maxf(fp::maxf(fp::minf(t1x, t2x),
                                        fp::minf(t1y, t2y)),
                               fp::minf(t1z, t2z));
  const float t_out = fp::minf(fp::minf(fp::maxf(t1x, t2x),
                                        fp::maxf(t1y, t2y)),
                               fp::maxf(t1z, t2z));
  const float t0 = fp::maxf(t_ent, 0.0f);
  const bool misses_box = (t_ent > t_out) || (t_out < 0.0f);
  const float push = t0 > 0.0f ? t0 + 1e-4f * cell : 0.0f;
  const float qx = px + push * dxc;
  const float qy = py + push * dyc;
  const float qz = pz + push * dzc;

  Dda r;
  r.ix = wf::clampi((int)(qx / cell), 0, n - 1);
  r.iy = wf::clampi((int)(qy / cell), 0, n - 1);
  r.iz = wf::clampi((int)(qz / cell), 0, n - 1);
  const int sx = dxc > 0.0f ? 1 : -1;
  const int sy = dyc > 0.0f ? 1 : -1;
  const int sz = dzc > 0.0f ? 1 : -1;
  const float nx = (float)(dxc > 0.0f ? r.ix + 1 : r.ix) * cell;
  const float ny = (float)(dyc > 0.0f ? r.iy + 1 : r.iy) * cell;
  const float nz = (float)(dzc > 0.0f ? r.iz + 1 : r.iz) * cell;
  float tx = push + (nx - qx) * inv_x;
  float ty = push + (ny - qy) * inv_y;
  float tz = push + (nz - qz) * inv_z;
  const float adx = fabsf(inv_x) * cell;
  const float ady = fabsf(inv_y) * cell;
  const float adz = fabsf(inv_z) * cell;
  r.hit = false;
  r.steps = 0;
  r.t = misses_box ? 0.0f : push;
  for (int s = 0; s < max_steps && !misses_box; ++s) {
    if (r.ix < 0 || r.ix >= n || r.iy < 0 || r.iy >= n || r.iz < 0 ||
        r.iz >= n)
      break;
    if (probe(r.ix, r.iy, r.iz)) {
      r.hit = true;
      break;
    }
    r.steps += 1;
    const bool mx = tx <= ty && tx <= tz;
    const bool my = !mx && ty <= tz;
    r.t = fp::minf(fp::minf(tx, ty), tz);
    if (mx) {
      r.ix += sx;
      tx = tx + adx;
    } else if (my) {
      r.iy += sy;
      ty = ty + ady;
    } else {
      r.iz += sz;
      tz = tz + adz;
    }
  }
  r.inside = !misses_box && r.ix >= 0 && r.ix < n && r.iy >= 0 &&
             r.iy < n && r.iz >= 0 && r.iz < n;
  return r;
}

// One ray from its voxel-unit origin (ox, oy, oz) along (dx, dy, dz):
// up to max_rounds rounds of phase 1 + phase 2 (file comment).  Positions
// of a round and of a uniform-solid entry voxel step along the unclamped
// direction; the phase-2 start inside the round along the clamped one.
// Every table is read through the read-only path (wf::ldg).
__host__ __device__ inline Out trace_ray(const Scene& S, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, bool alive,
                                         int max_rounds) {
  Out out;
  out.hit = 0;
  out.attr = 0;
  out.hvox = 0;
  out.t = 0.0f;
  out.iters = 0;
  if (!alive) return out;
  const int G = S.G, ws = S.ws;
  const float dxc = wf::clamp_dir(dx), dyc = wf::clamp_dir(dy),
              dzc = wf::clamp_dir(dz);
  const float inv_x = 1.0f / dxc, inv_y = 1.0f / dyc, inv_z = 1.0f / dzc;
  const Bits l0 = {S.l0, G};
  float t_tot = 0.0f;
  int slot = -1, cell = 0;
  for (int rnd = 0; rnd < max_rounds; ++rnd) {
    const float px = ox + t_tot * dx;
    const float py = oy + t_tot * dy;
    const float pz = oz + t_tot * dz;
    // ---- phase 1: voxel DDA inside the current mixed brick
    float t2_0 = 0.0f;
    if (slot >= 0) {
      const float bx = (float)(cell / (G * G)) * 32.0f;
      const float by = (float)((cell / G) % G) * 32.0f;
      const float bz = (float)(cell % G) * 32.0f;
      const Bits occ = {S.occ + (size_t)slot * 1024, 32};
      const Dda r1 = dda_vec(px - bx, py - by, pz - bz, dxc, dyc, dzc, inv_x,
                             inv_y, inv_z, 32, 1.0f, occ, INNER_STEPS);
      out.iters += r1.steps;
      if (r1.hit) {
        const int widx = (r1.ix * 32 + r1.iy) * 32 + r1.iz;
        const int gx = (cell / (G * G)) * 32 + r1.ix;
        const int gy = ((cell / G) % G) * 32 + r1.iy;
        const int gz = (cell % G) * 32 + r1.iz;
        out.hit = 1;
        out.attr =
            (int32_t)wf::ldg(S.attrs + (size_t)slot * BRICK_WORDS + widx);
        out.hvox = (gx * ws + gy) * ws + gz;
        out.t = t_tot + r1.t;
        return out;
      }
      t2_0 = r1.t + EXIT_EPS;
    }
    // ---- phase 2: L0 march to the next occupied brick
    const Dda r2 = dda_vec(px + t2_0 * dxc, py + t2_0 * dyc, pz + t2_0 * dzc,
                           dxc, dyc, dzc, inv_x, inv_y, inv_z, G, 32.0f, l0,
                           3 * G + 4);
    out.iters += r2.steps;
    if (!r2.hit && !r2.inside) return out;  // left the world: a miss
    // ---- a stop: classify the L0 cell
    const float r_t = t2_0 + r2.t;
    const int cell2 = wf::clampi((r2.ix * G + r2.iy) * G + r2.iz, 0,
                                 G * G * G - 1);
    const int s2 = (int)wf::ldg(S.brick_slot + cell2);
    const int32_t uattr = (int32_t)wf::ldg(S.brick_attr + cell2);
    if (s2 < 0 && (uattr & 0xFF) != 0) {
      // uniform-solid brick: a hit at its entry voxel
      const int bx = (cell2 / (G * G)) * 32;
      const int by = ((cell2 / G) % G) * 32;
      const int bz = (cell2 % G) * 32;
      const int ex = wf::clampi((int)(px + r_t * dx), bx, bx + 31);
      const int ey = wf::clampi((int)(py + r_t * dy), by, by + 31);
      const int ez = wf::clampi((int)(pz + r_t * dz), bz, bz + 31);
      out.hit = 1;
      out.attr = uattr;
      out.hvox = (ex * ws + ey) * ws + ez;
      out.t = t_tot + r_t;
      return out;
    }
    slot = s2 >= 0 ? s2 : -1;
    cell = cell2;
    t_tot = t_tot + r_t;
  }
  return out;  // still pending after max_rounds: a miss
}

}  // namespace br
