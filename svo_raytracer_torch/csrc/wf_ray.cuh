// Kernel K1, per-ray body: the brick-wavefront traversal of one ray.
//
// Replaces the per-lane arithmetic of svo_raytracer_tpu/ops/wavefront.py
// ::_wf_kernel (its `crossing`, :1252-1423), the coarse-refine DDA
// `_dda_cr` (:645-883) and the paged L0 march `_paged_march`
// (:1077-1241), for explicit and camera-mode rays: flat L0 worlds up to
// G = 64 bricks per edge (2048^3) and paged worlds of G = 128 and 256
// (4096^3, 8192^3).
// The TPU kernel advances 1024-ray tiles in sorted rounds against KMAX
// prefetched candidate bricks and KPAGE candidate pages, because Mosaic
// has no arbitrary gather.  Here a lane owns one ray at a time and loads
// any table word it needs, one crossing per call of `cross` below, until
// the ray hits, misses or passes ITER_CAP — the per-ray answer the TPU's
// serve loop computes (wavefront.py:1479-1534).  Between crossings the
// ray lives in a RayState; the kernel (wavefront.cu) does not refill a
// lane whose ray ended: a warp takes its next 32 ids once all its lanes
// are done.  Every page's tables are at hand, so a
// ray never punts off an unserved page: the TPU's page-band keys
// (:1262-1263, :1399-1402) have no counterpart.
//
// Camera mode (the kernel's camera branch, :987-1027) derives each
// primary ray from its id and 16 camera scalars instead of reading origin
// and direction arrays: `camera_ray` below.
//
// The record is the port's own (status, t, cell, widx, iters) at every G:
// the hit cell gives the mixed slot through brick_slot, so the TPU's
// 15-bit and 29-bit slot packings are not needed.
//
// Plain C types only, `__host__ __device__` throughout: the CUDA kernel
// (wavefront.cu) and a g++ build for the CPU parity test include the same
// code.  The plain PyTorch version is ops/wavefront.py::trace_plain; keep
// the arithmetic in the same order (no fused multiply-add: nvcc builds
// with -fmad=false, g++ with -ffp-contract=off).
#pragma once

#include <math.h>
#include <stdint.h>

namespace wf {

constexpr int32_t KEY_INIT = -2;     // ray not yet L0-marched (start / stuck)
constexpr float EXIT_EPS = 1e-2f;    // voxel-unit nudge across brick boundaries
constexpr float DIR_EPS = 1e-4f;     // |d| floor before 1/d (wavefront.py:134)
constexpr int ITER_CAP = 4000;       // per-ray coarse-step kill switch
constexpr int MAX_CROSSINGS = 4096;  // termination guard on crossings
constexpr int INNER_CAP = 100;       // phase-1 step budget (_resolve_caps)
constexpr int PAGE = 64;             // bricks per page edge (paged L0)
constexpr int PAGE_ROWS = 137;       // 128-word rows of one page's tables

enum : int32_t { MISS = 0, MIXED = 1, UNIFORM = 2, CAPPED = 3 };

// Every table word is read through ldg().
struct Tables {
  const int32_t* l0_occ;      // L0 byte-cell words, then coarse-bit words;
                              // paged: page-occupancy bits
  const int32_t* l0_mixed;    // mixed-brick bits: word (x*G + y)*zw + z/32,
                              // bit z%32; paged: PAGE_ROWS rows per page
  const int32_t* l0_sc;       // supercell chebyshev-distance nibbles
  const int32_t* brick_slot;  // (G^3,) mixed slot or -1
  const int32_t* occ_words;   // (capacity, 1024) brick byte-cell words
  const int32_t* sc_words;    // (capacity, 128) brick coarse-bit words
  int G;                      // bricks per edge
  int l0_coarse_base;         // word offset of the L0 coarse-bit rows
  int zw;                     // z-words per L0 mixed column, ceil(G/32)
  int pages;                  // pages per edge (G/64), 0 for a flat L0
};

// The Tables of the entry points' flat argument list (wavefront.cu and
// its CPU build take the same list).
inline Tables make_tables(const int32_t* l0_occ, const int32_t* l0_mixed,
                          const int32_t* l0_sc, const int32_t* brick_slot,
                          const int32_t* occ_words, const int32_t* sc_words,
                          int G, int l0_coarse_base, int zw, int pages) {
  Tables T;
  T.l0_occ = l0_occ;
  T.l0_mixed = l0_mixed;
  T.l0_sc = l0_sc;
  T.brick_slot = brick_slot;
  T.occ_words = occ_words;
  T.sc_words = sc_words;
  T.G = G;
  T.l0_coarse_base = l0_coarse_base;
  T.zw = zw;
  T.pages = pages;
  return T;
}

struct RayOut {
  int32_t status;  // MISS, MIXED, UNIFORM or CAPPED
  float t;         // voxel units: hit entry t, 0 on miss, march t if capped
  int32_t cell;    // hit brick cell (bx*G + by)*G + bz
  int32_t widx;    // hit voxel within the brick (vx*32 + vy)*32 + vz
  int32_t iters;   // coarse DDA steps over both phases
};

// Writes ray i's record into the (n,) output arrays.
__host__ __device__ inline void store(const RayOut& r, int i, int32_t* status,
                                      float* t, int32_t* cell, int32_t* widx,
                                      int32_t* iters) {
  status[i] = r.status;
  t[i] = r.t;
  cell[i] = r.cell;
  widx[i] = r.widx;
  iters[i] = r.iters;
}

struct DdaOut {
  bool hit;
  int ix, iy, iz;  // fine cell of the hit, or 2x the last coarse cell
  float t;         // entry t of the hit fine cell, else how far it got
  bool inside;     // still inside the grid (budget spent, not exited)
  int steps;
};

__host__ __device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__host__ __device__ inline float clamp_dir(float d) {
  return fabsf(d) < DIR_EPS ? (d >= 0.0f ? DIR_EPS : -DIR_EPS) : d;
}

// A read-only table word: through the non-coherent read-only path
// (__ldg) on the card, a plain load in the CPU build.
__host__ __device__ inline uint32_t ldg(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__ldg(p);
#else
  return (uint32_t)*p;
#endif
}

// 32^3 mixed brick: 16^3 coarse any-bits (128 words) and byte-cell words
// (byte c&3 of word c>>2 holds coarse cell c's eight fine bits).
struct BrickProbe {
  const int32_t* occ;
  const int32_t* sc;
  __host__ __device__ bool coarse(int cx, int cy, int cz) const {
    int c = (cx * 16 + cy) * 16 + cz;
    return ((ldg(sc + (c >> 5)) >> (c & 31)) & 1u) != 0;
  }
  __host__ __device__ uint32_t fine_byte(int cx, int cy, int cz) const {
    int c = (cx * 16 + cy) * 16 + cz;
    return (ldg(occ + (c >> 2)) >> ((c & 3) * 8)) & 0xFFu;
  }
  __host__ __device__ int sc_dist(int, int, int) const { return 0; }
};

// A brick grid in the same coarse-refine layout over occupied bricks,
// plus the supercell (8^3-brick) distance nibbles: the flat L0, or one
// 64^3-brick page of a paged world.
struct GridProbe {
  const int32_t* byte_words;    // byte c&3 of word c>>2: coarse cell c
  const int32_t* coarse_words;  // bit c&31 of word c>>5: coarse cell c
  const int32_t* sc_words;      // nibble b&7 of word b>>3: supercell b
  int hh;   // coarse cells per edge (G/2, at least 1)
  int nsc;  // supercells per edge (G/8)
  __host__ __device__ bool coarse(int cx, int cy, int cz) const {
    int c = (cx * hh + cy) * hh + cz;
    return ((ldg(coarse_words + (c >> 5)) >> (c & 31)) & 1u) != 0;
  }
  __host__ __device__ uint32_t fine_byte(int cx, int cy, int cz) const {
    int c = (cx * hh + cy) * hh + cz;
    return (ldg(byte_words + (c >> 2)) >> ((c & 3) * 8)) & 0xFFu;
  }
  __host__ __device__ int sc_dist(int sx, int sy, int sz) const {
    int b = (sx * nsc + sy) * nsc + sz;
    return (int)((ldg(sc_words + (b >> 3)) >> ((b & 7) * 4)) & 0xFu);
  }
};

// Coarse-refine DDA over an n^3 grid of `cell`-edge fine cells in
// [0, n*cell]^3 (wavefront.py::_dda_cr): steps at 2x2x2-fine-cell coarse
// granularity, refines occupied coarse cells with an unrolled <=4-step
// sub-DDA over their fine bits, and (use_sc) jumps empty supercells by
// their chebyshev distance in one step.  Ties break x first, then y.
template <class Probe>
__host__ __device__ inline DdaOut dda_cr(
    float px, float py, float pz, float dxc, float dyc, float dzc,
    float inv_x, float inv_y, float inv_z, int n, float cell,
    const Probe& probe, int max_steps, bool use_sc) {
  const int n2 = n / 2 > 1 ? n / 2 : 1;
  const float cell2 = 2.0f * cell;
  const float gf = (float)n * cell;
  const float eps_c = 1e-4f * cell;
  const float eps_c2 = 1e-4f * cell2;
  const float t1x = (0.0f - px) * inv_x, t2x = (gf - px) * inv_x;
  const float t1y = (0.0f - py) * inv_y, t2y = (gf - py) * inv_y;
  const float t1z = (0.0f - pz) * inv_z, t2z = (gf - pz) * inv_z;
  const float t_ent = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                            fminf(t1z, t2z));
  const float t_out = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fmaxf(t1z, t2z));
  const float t0 = fmaxf(t_ent, 0.0f);
  const bool misses_box = (t_ent > t_out) || (t_out < 0.0f);
  // entry push by 1e-4 cell, none when the ray starts inside
  const float push = t0 > 0.0f ? t0 + eps_c : 0.0f;
  const float qx = px + push * dxc;
  const float qy = py + push * dyc;
  const float qz = pz + push * dzc;

  // cell indices truncate (astype(i32)); the refine and jumps use floor
  int cx = clampi((int)(qx / cell2), 0, n2 - 1);
  int cy = clampi((int)(qy / cell2), 0, n2 - 1);
  int cz = clampi((int)(qz / cell2), 0, n2 - 1);
  const int sx = dxc > 0.0f ? 1 : -1;
  const int sy = dyc > 0.0f ? 1 : -1;
  const int sz = dzc > 0.0f ? 1 : -1;
  // boundary ts in absolute form: push + (boundary - q) / d
  const float nx = (float)(dxc > 0.0f ? cx + 1 : cx) * cell2;
  const float ny = (float)(dyc > 0.0f ? cy + 1 : cy) * cell2;
  const float nz = (float)(dzc > 0.0f ? cz + 1 : cz) * cell2;
  float tx = push + (nx - qx) * inv_x;
  float ty = push + (ny - qy) * inv_y;
  float tz = push + (nz - qz) * inv_z;
  const float adx = fabsf(inv_x) * cell2;
  const float ady = fabsf(inv_y) * cell2;
  const float adz = fabsf(inv_z) * cell2;
  const float fadx = fabsf(inv_x) * cell;
  const float fady = fabsf(inv_y) * cell;
  const float fadz = fabsf(inv_z) * cell;

  DdaOut r;
  r.hit = false;
  r.steps = 0;
  float t_cur = misses_box ? 0.0f : push;
  int fx = 0, fy = 0, fz = 0;
  float t_hit = t_cur;
  for (int k = 0; k < max_steps && !misses_box; ++k) {
    const bool inside = cx >= 0 && cx < n2 && cy >= 0 && cy < n2 &&
                        cz >= 0 && cz < n2;
    if (!inside) break;
    const int ccx = clampi(cx, 0, n2 - 1);
    const int ccy = clampi(cy, 0, n2 - 1);
    const int ccz = clampi(cz, 0, n2 - 1);
    if (probe.coarse(ccx, ccy, ccz)) {
      // refine: walk the <= 4 fine cells of this coarse cell on the ray
      const uint32_t byte = probe.fine_byte(ccx, ccy, ccz);
      const float tin = t_cur + eps_c;
      const float qrx = px + tin * dxc;
      const float qry = py + tin * dyc;
      const float qrz = pz + tin * dzc;
      int gx = clampi((int)floorf(qrx / cell), ccx * 2, ccx * 2 + 1);
      int gy = clampi((int)floorf(qry / cell), ccy * 2, ccy * 2 + 1);
      int gz = clampi((int)floorf(qrz / cell), ccz * 2, ccz * 2 + 1);
      const float bfx = (float)(dxc > 0.0f ? gx + 1 : gx) * cell;
      const float bfy = (float)(dyc > 0.0f ? gy + 1 : gy) * cell;
      const float bfz = (float)(dzc > 0.0f ? gz + 1 : gz) * cell;
      float ftx = (bfx - px) * inv_x;
      float fty = (bfy - py) * inv_y;
      float ftz = (bfz - pz) * inv_z;
      float ts = t_cur;
      for (int s = 0; s < 4; ++s) {
        const uint32_t bit =
            (byte >> (((gx & 1) << 2) | ((gy & 1) << 1) | (gz & 1))) & 1u;
        if (bit) {
          r.hit = true;
          fx = gx;
          fy = gy;
          fz = gz;
          t_hit = ts;
          break;
        }
        if (s == 3) break;
        const bool fmx = ftx <= fty && ftx <= ftz;
        const bool fmy = !fmx && fty <= ftz;
        ts = fminf(fminf(ftx, fty), ftz);
        if (fmx) {
          gx += sx;
          ftx = ftx + fadx;
        } else if (fmy) {
          gy += sy;
          fty = fty + fady;
        } else {
          gz += sz;
          ftz = ftz + fadz;
        }
        if ((gx >> 1) != ccx || (gy >> 1) != ccy || (gz >> 1) != ccz) break;
      }
      if (r.hit) break;
    }
    r.steps += 1;
    const bool mx = tx <= ty && tx <= tz;
    const bool my = !mx && ty <= tz;
    t_cur = fminf(fminf(tx, ty), tz);
    int cx2 = cx, cy2 = cy, cz2 = cz;
    float tx2 = tx, ty2 = ty, tz2 = tz;
    if (mx) {
      cx2 = cx + sx;
      tx2 = tx + adx;
    } else if (my) {
      cy2 = cy + sy;
      ty2 = ty + ady;
    } else {
      cz2 = cz + sz;
      tz2 = tz + adz;
    }
    if (use_sc) {
      // empty supercell: cross d-1 more supercells, clipped to the box
      const int d_sc = probe.sc_dist(ccx >> 2, ccy >> 2, ccz >> 2);
      if (d_sc > 0) {
        const float ext = (float)(d_sc - 1) * 4.0f;
        const float remx = (float)(sx > 0 ? 3 - (ccx & 3) : (ccx & 3));
        const float remy = (float)(sy > 0 ? 3 - (ccy & 3) : (ccy & 3));
        const float remz = (float)(sz > 0 ? 3 - (ccz & 3) : (ccz & 3));
        float t_exit = fminf(fminf(tx + (remx + ext) * adx,
                                   ty + (remy + ext) * ady),
                             tz + (remz + ext) * adz) + eps_c2;
        t_exit = fminf(t_exit, t_out + eps_c2);
        const float qx2 = px + t_exit * dxc;
        const float qy2 = py + t_exit * dyc;
        const float qz2 = pz + t_exit * dzc;
        const int nix = (int)floorf(qx2 / cell2);
        const int niy = (int)floorf(qy2 / cell2);
        const int niz = (int)floorf(qz2 / cell2);
        const float bnx = (float)(dxc > 0.0f ? nix + 1 : nix) * cell2;
        const float bny = (float)(dyc > 0.0f ? niy + 1 : niy) * cell2;
        const float bnz = (float)(dzc > 0.0f ? niz + 1 : niz) * cell2;
        cx2 = nix;
        cy2 = niy;
        cz2 = niz;
        tx2 = t_exit + (bnx - qx2) * inv_x;
        ty2 = t_exit + (bny - qy2) * inv_y;
        tz2 = t_exit + (bnz - qz2) * inv_z;
        t_cur = t_exit;
      }
    }
    cx = cx2;
    cy = cy2;
    cz = cz2;
    tx = tx2;
    ty = ty2;
    tz = tz2;
  }
  r.ix = r.hit ? fx : cx * 2;
  r.iy = r.hit ? fy : cy * 2;
  r.iz = r.hit ? fz : cz * 2;
  r.t = r.hit ? t_hit : t_cur;
  r.inside = !misses_box && cx >= 0 && cx < n2 && cy >= 0 && cy < n2 &&
             cz >= 0 && cz < n2;
  return r;
}

// Phase 2 of a paged world (wavefront.py::_paged_march): from the box
// entry (pushed by EXIT_EPS), at most 3*P + 4 passes, each on the page
// of the current point.  An empty page (page-occupancy bit clear) jumps
// to its exit plus EXIT_EPS and counts one step; an occupied page runs
// the G = 64 coarse-refine march on that page's rows (byte 0, coarse 64,
// supercell 136) from the page-relative point and, on a hit, classifies
// the brick through the page's mixed-byte rows (72).  Returns the flat
// march's contract with global brick coords; `*mixed` is the class.
__host__ __device__ inline DdaOut paged_march(
    const Tables& T, float p2x, float p2y, float p2z, float dxc, float dyc,
    float dzc, float inv_x, float inv_y, float inv_z, bool* mixed) {
  const int P = T.pages;
  const float pgv = (float)(PAGE * 32);
  const float gf = (float)T.G * 32.0f;
  const float t1x = (0.0f - p2x) * inv_x, t2x = (gf - p2x) * inv_x;
  const float t1y = (0.0f - p2y) * inv_y, t2y = (gf - p2y) * inv_y;
  const float t1z = (0.0f - p2z) * inv_z, t2z = (gf - p2z) * inv_z;
  const float t_ent = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                            fminf(t1z, t2z));
  const float t_out = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fmaxf(t1z, t2z));
  const bool miss_box = (t_ent > t_out) || (t_out < 0.0f);
  const float t00 = fmaxf(t_ent, 0.0f);
  DdaOut r;
  r.hit = false;
  r.ix = r.iy = r.iz = 0;
  r.steps = 0;
  r.inside = !miss_box;
  *mixed = false;
  float t_rel = miss_box ? 0.0f : (t00 > 0.0f ? t00 + EXIT_EPS : 0.0f);
  for (int k = 0; k < 3 * P + 4 && !miss_box; ++k) {
    const float qx = p2x + t_rel * dxc;
    const float qy = p2y + t_rel * dyc;
    const float qz = p2z + t_rel * dzc;
    const int pgx = (int)floorf(qx / pgv);
    const int pgy = (int)floorf(qy / pgv);
    const int pgz = (int)floorf(qz / pgv);
    if (pgx < 0 || pgx >= P || pgy < 0 || pgy >= P || pgz < 0 || pgz >= P) {
      r.inside = false;
      break;
    }
    const int pg = (pgx * P + pgy) * P + pgz;
    if (((ldg(T.l0_occ + (pg >> 5)) >> (pg & 31)) & 1u) == 0) {
      // empty page: jump to its exit
      const float ex = ((float)pgx * pgv + (dxc > 0.0f ? pgv : 0.0f) - p2x)
                       * inv_x;
      const float ey = ((float)pgy * pgv + (dyc > 0.0f ? pgv : 0.0f) - p2y)
                       * inv_y;
      const float ez = ((float)pgz * pgv + (dzc > 0.0f ? pgv : 0.0f) - p2z)
                       * inv_z;
      t_rel = fminf(fminf(ex, ey), ez) + EXIT_EPS;
      r.steps += 1;
      continue;
    }
    const int32_t* tab = T.l0_mixed + (size_t)pg * PAGE_ROWS * 128;
    GridProbe pp;
    pp.byte_words = tab;
    pp.coarse_words = tab + 64 * 128;
    pp.sc_words = tab + 136 * 128;
    pp.hh = PAGE / 2;
    pp.nsc = PAGE / 8;
    const DdaOut d = dda_cr(
        qx - (float)pgx * pgv, qy - (float)pgy * pgv, qz - (float)pgz * pgv,
        dxc, dyc, dzc, inv_x, inv_y, inv_z, PAGE, 32.0f, pp, 3 * PAGE + 4,
        true);
    r.steps += d.steps;
    if (d.hit) {
      const int cix = clampi(d.ix, 0, PAGE - 1);
      const int ciy = clampi(d.iy, 0, PAGE - 1);
      const int ciz = clampi(d.iz, 0, PAGE - 1);
      const int cc = ((cix >> 1) * 32 + (ciy >> 1)) * 32 + (ciz >> 1);
      const uint32_t byte =
          (ldg(tab + 72 * 128 + (cc >> 2)) >> ((cc & 3) * 8)) & 0xFFu;
      *mixed = ((byte >> (((cix & 1) << 2) | ((ciy & 1) << 1) | (ciz & 1)))
                & 1u) != 0;
      r.hit = true;
      r.ix = pgx * PAGE + d.ix;
      r.iy = pgy * PAGE + d.iy;
      r.iz = pgz * PAGE + d.iz;
      t_rel = t_rel + d.t;
      break;
    }
    if (d.inside) {
      // budget spent inside the page: stuck (the caller restarts past it)
      t_rel = t_rel + d.t;
      break;
    }
    t_rel = t_rel + d.t + EXIT_EPS;
  }
  r.t = t_rel;
  return r;
}

// A ray between two crossings: its voxel-unit origin, clamped direction
// and reciprocals, and the loop state of the crossing walk (the brick to
// enter or KEY_INIT, the march t, the coarse steps so far, the crossings
// taken).  A lane of K1 holds one and may switch to another ray between
// crossings.
struct RayState {
  float ox, oy, oz;
  float dxc, dyc, dzc;
  float inv_x, inv_y, inv_z;
  int32_t key;  // KEY_INIT or the mixed brick cell to enter
  float tw;
  int it;
  int crossing;
};

__host__ __device__ inline RayState start_ray(float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  RayState s;
  s.ox = ox;
  s.oy = oy;
  s.oz = oz;
  s.dxc = clamp_dir(dx);
  s.dyc = clamp_dir(dy);
  s.dzc = clamp_dir(dz);
  s.inv_x = 1.0f / s.dxc;
  s.inv_y = 1.0f / s.dyc;
  s.inv_z = 1.0f / s.dzc;
  s.key = KEY_INIT;
  s.tw = 0.0f;
  s.it = 0;
  s.crossing = 0;
  return s;
}

// The record of a ray that is not traced (inactive or non-finite).
__host__ __device__ inline RayOut miss_record() {
  RayOut out;
  out.status = MISS;
  out.t = 0.0f;
  out.cell = 0;
  out.widx = 0;
  out.iters = 0;
  return out;
}

__host__ __device__ inline bool finish(RayOut* out, int32_t status, float t,
                                       int32_t cell, int32_t widx,
                                       int32_t iters) {
  out->status = status;
  out->t = t;
  out->cell = cell;
  out->widx = widx;
  out->iters = iters;
  return true;
}

// One crossing of a ray: phase 1 (the voxel DDA inside the current mixed
// brick) and phase 2 (the L0 march to the next occupied brick, classified
// mixed or uniform); a uniform-solid brick is a hit on its entry face.
// Returns true when the ray is done (hit, miss, ITER_CAP or
// MAX_CROSSINGS), with its record in *out; else `s` holds the ray for its
// next crossing.  Looping it from start_ray until it returns true is the
// whole per-ray walk; PAGED selects the paged L0 (T.pages > 0).
template <bool PAGED>
__host__ __device__ inline bool cross(const Tables& T, RayState& s,
                                      RayOut* out) {
  const int G = T.G;
  const float dxc = s.dxc, dyc = s.dyc, dzc = s.dzc;
  const float inv_x = s.inv_x, inv_y = s.inv_y, inv_z = s.inv_z;
  const bool m_init = s.key == KEY_INIT;
  float t1 = 0.0f;
  int st1 = 0;
  if (!m_init) {
    // ---- phase 1: voxel DDA through mixed brick `key`, brick-local
    const int kc = s.key;
    const float bxv = (float)(kc / (G * G)) * 32.0f;
    const float byv = (float)((kc / G) % G) * 32.0f;
    const float bzv = (float)(kc % G) * 32.0f;
    const float px = s.ox + s.tw * dxc;
    const float py = s.oy + s.tw * dyc;
    const float pz = s.oz + s.tw * dzc;
    const int sl = (int)ldg(T.brick_slot + kc);
    const int slot = sl > 0 ? sl : 0;
    BrickProbe bp;
    bp.occ = T.occ_words + (size_t)slot * 1024;
    bp.sc = T.sc_words + (size_t)slot * 128;
    const DdaOut r1 = dda_cr(px - bxv, py - byv, pz - bzv, dxc, dyc, dzc,
                             inv_x, inv_y, inv_z, 32, 1.0f, bp, INNER_CAP,
                             false);
    if (r1.hit) {
      return finish(out, MIXED, s.tw + r1.t, kc,
                    (r1.ix * 32 + r1.iy) * 32 + r1.iz, s.it + r1.steps);
    }
    t1 = r1.t;
    st1 = r1.steps;
  }
  // ---- phase 2: L0 march from just past the brick exit
  const float t2_0 = m_init ? s.tw : s.tw + t1 + EXIT_EPS;
  const float p2x = s.ox + t2_0 * dxc;
  const float p2y = s.oy + t2_0 * dyc;
  const float p2z = s.oz + t2_0 * dzc;
  bool is_mixed = false;
  DdaOut r2;
  if (PAGED) {
    r2 = paged_march(T, p2x, p2y, p2z, dxc, dyc, dzc, inv_x, inv_y, inv_z,
                     &is_mixed);
  } else {
    GridProbe l0;
    l0.byte_words = T.l0_occ;
    l0.coarse_words = T.l0_occ + T.l0_coarse_base;
    l0.sc_words = T.l0_sc;
    l0.hh = G / 2 > 1 ? G / 2 : 1;
    l0.nsc = G / 8;
    r2 = dda_cr(p2x, p2y, p2z, dxc, dyc, dzc, inv_x, inv_y, inv_z, G, 32.0f,
                l0, 3 * G + 4, G >= 8);
    if (r2.hit) {
      const int c2x = clampi(r2.ix, 0, G - 1);
      const int c2y = clampi(r2.iy, 0, G - 1);
      const int c2z = clampi(r2.iz, 0, G - 1);
      is_mixed = ((ldg(T.l0_mixed + (c2x * G + c2y) * T.zw + (c2z >> 5))
                   >> (c2z & 31)) & 1u) != 0;
    }
  }
  s.it += st1 + r2.steps;
  if (r2.hit) {
    const int cell2 = (r2.ix * G + r2.iy) * G + r2.iz;
    if (is_mixed) {
      s.key = cell2;
      s.tw = t2_0 + r2.t;
    } else {
      // uniform-solid brick: hit at the entry face
      const int ux = clampi((int)(p2x + r2.t * dxc) - r2.ix * 32, 0, 31);
      const int uy = clampi((int)(p2y + r2.t * dyc) - r2.iy * 32, 0, 31);
      const int uz = clampi((int)(p2z + r2.t * dzc) - r2.iz * 32, 0, 31);
      return finish(out, UNIFORM, t2_0 + r2.t, cell2,
                    (ux * 32 + uy) * 32 + uz, s.it);
    }
  } else if (r2.inside) {
    // budget spent inside the grid: restart the L0 march further on
    s.key = KEY_INIT;
    s.tw = t2_0 + r2.t + EXIT_EPS;
  } else {
    return finish(out, MISS, 0.0f, 0, 0, s.it);
  }
  if (s.it >= ITER_CAP || ++s.crossing >= MAX_CROSSINGS) {
    return finish(out, CAPPED, s.tw, 0, 0, s.it);
  }
  return false;
}

// cross() with the L0 layout chosen at run time (the CPU build's loop).
__host__ __device__ inline bool cross_any(const Tables& T, RayState& s,
                                          RayOut* out) {
  return T.pages > 0 ? cross<true>(T, s, out) : cross<false>(T, s, out);
}

// The sort key of an explicit ray (ops/wavefront.py::ray_keys_plain):
// the direction octant (bit 2 x, 1 y, 0 z; set where d >= 0, the sign
// clamp_dir gives) in bits 24-26 above the Morton code of the brick cell
// that holds the voxel-unit origin (clamped into the grid; bits 3i+2,
// 3i+1, 3i of the code are bit i of x, y, z; G <= 256).  Rays that are
// not alive or not finite take KEY_DEAD, so they sort to the tail.
constexpr int32_t KEY_DEAD = 0x7FFFFFFF;

__host__ __device__ inline uint32_t spread3(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__host__ __device__ inline bool is_finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

__host__ __device__ inline int brick_coord(float v, int G) {
  return (int)fminf(fmaxf(floorf(v * 0.03125f), 0.0f), (float)(G - 1));
}

__host__ __device__ inline int32_t ray_key(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           bool alive, int G) {
  if (!(alive && is_finite(ox) && is_finite(oy) && is_finite(oz) &&
        is_finite(dx) && is_finite(dy) && is_finite(dz))) {
    return KEY_DEAD;
  }
  const uint32_t oct = (dx >= 0.0f ? 4u : 0u) | (dy >= 0.0f ? 2u : 0u) |
                       (dz >= 0.0f ? 1u : 0u);
  const uint32_t m = (spread3((uint32_t)brick_coord(ox, G)) << 2) |
                     (spread3((uint32_t)brick_coord(oy, G)) << 1) |
                     spread3((uint32_t)brick_coord(oz, G));
  return (int32_t)((oct << 24) | m);
}

// Ray ids a warp of K1 takes from the global counter at a time, one per
// lane (wavefront.cu; the CPU build emulates the same schedule).
constexpr int CHUNK = 32;

// Camera mode: a primary ray is derived from its id and the 16 camera
// scalars (pos, l1, l2, r1, r2, one pad; Camera.uniform order), so the
// rays carry no origin or direction arrays.
struct Camera {
  const float* c;  // the 16 scalars
  int W, H;        // image size
  int nbx;         // > 0: ids walk 32x32-pixel blocks, nbx blocks per row
  float ws;        // world size: voxel-unit origin (pos - 1) * ws
};

// The pixel of primary `rid`: block-major or row-major decode.  A pad row
// of block mode has y >= H.
__host__ __device__ inline void camera_pixel(const Camera& cam, int rid,
                                             int* pxi, int* pyi) {
  if (cam.nbx > 0) {
    const int bi = rid / 1024;
    const int off = rid - bi * 1024;
    const int by = bi / cam.nbx;
    const int bx = bi - by * cam.nbx;
    const int ly = off / 32;
    *pyi = by * 32 + ly;
    *pxi = bx * 32 + (off - ly * 32);
  } else {
    *pyi = rid / cam.W;
    *pxi = rid - *pyi * cam.W;
  }
}

// The unit direction through pixel (pxi, pyi): pad rows clamped to the
// last real row, the corner mix of svotrace.comp:662-664, then
// normalization.
__host__ __device__ inline void camera_dir(const Camera& cam, int pxi,
                                           int pyi, float* d) {
  pyi = pyi < cam.H - 1 ? pyi : cam.H - 1;
  const float u = ((float)pxi + 0.5f) / (float)cam.W;
  const float v = ((float)pyi + 0.5f) / (float)cam.H;
  const float* c = cam.c;
  float dun[3];
  for (int ax = 0; ax < 3; ++ax) {
    const float left = c[3 + ax] + (c[6 + ax] - c[3 + ax]) * v;
    const float right = c[9 + ax] + (c[12 + ax] - c[9 + ax]) * v;
    dun[ax] = left + (right - left) * u;
  }
  const float nrm = sqrtf(dun[0] * dun[0] + dun[1] * dun[1] + dun[2] * dun[2]);
  for (int ax = 0; ax < 3; ++ax) d[ax] = dun[ax] / nrm;
}

// Primary ray `rid` (wavefront.py::_wf_kernel's camera branch, :997-1027,
// operation for operation): its pixel, its direction, and the camera's
// voxel-unit origin.
__host__ __device__ inline void camera_ray(const Camera& cam, int rid,
                                           float* o, float* d) {
  int pxi, pyi;
  camera_pixel(cam, rid, &pxi, &pyi);
  camera_dir(cam, pxi, pyi, d);
  for (int ax = 0; ax < 3; ++ax) o[ax] = (cam.c[ax] - 1.0f) * cam.ws;
}

// The state of camera-mode primary `rid`; every primary is traced.
__host__ __device__ inline RayState start_camera_ray(const Camera& cam,
                                                     int rid) {
  float o[3], d[3];
  camera_ray(cam, rid, o, d);
  return start_ray(o[0], o[1], o[2], d[0], d[1], d[2]);
}

}  // namespace wf
