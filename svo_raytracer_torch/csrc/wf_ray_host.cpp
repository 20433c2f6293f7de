// CPU build of kernel K1's per-ray body (wf_ray.cuh) and of its persistent
// schedule, for the parity test tests/test_torch_kernel_source.py, which
// compiles this file with g++ -D__host__= -D__device__= -ffp-contract=off
// and compares it with ops/wavefront.py::trace_plain, trace_camera_plain
// and ray_keys_plain.  No runtime path uses it: on a GPU the same header
// is compiled into wavefront.cu.
//
// The host loop emulates wavefront.cu's warps: WARPS warps of 32 lanes
// take turns.  A warp whose lanes are all done takes the next 32 ids of a
// shared counter, one per lane; otherwise each busy lane runs one
// crossing and writes its record, through the permutation, when its ray
// ends.

#include <stdint.h>

#include <vector>

#include "wf_ray.cuh"

namespace {

constexpr int WARPS = 3;
static_assert(wf::CHUNK == 32, "a warp takes one id per lane");

struct Lane {
  wf::RayState s;
  int slot;  // record slot of the lane's ray, -1 when done
};

struct Warp {
  Lane lane[32];
  bool done;  // the counter has passed n
};

struct Records {
  int32_t* status;
  float* t;
  int32_t* cell;
  int32_t* widx;
  int32_t* iters;
  void put(const wf::RayOut& r, int i) const {
    wf::store(r, i, status, t, cell, widx, iters);
  }
};

// begin(k, &state) -> record slot of id k's ray, or -1 if it is dead (and
// its record written).
template <class Begin>
void run_warps(const wf::Tables& T, int n, int* counter, const Records& out,
               Begin begin) {
  *counter = 0;
  std::vector<Warp> warps(WARPS);
  for (Warp& w : warps) {
    for (Lane& l : w.lane) l.slot = -1;
    w.done = false;
  }
  for (bool busy = true; busy;) {
    busy = false;
    for (Warp& w : warps) {
      if (w.done) continue;
      busy = true;
      bool idle = true;
      for (const Lane& l : w.lane) idle &= l.slot < 0;
      if (idle) {  // the warp's next 32 ids
        const int base = *counter;
        *counter += wf::CHUNK;
        w.done = base >= n;
        for (int i = 0; i < 32; ++i) {
          Lane& l = w.lane[i];
          l.slot = !w.done && base + i < n ? begin(base + i, &l.s) : -1;
        }
        continue;
      }
      for (Lane& l : w.lane) {
        wf::RayOut r;
        if (l.slot >= 0 && wf::cross_any(T, l.s, &r)) {
          out.put(r, l.slot);
          l.slot = -1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int wf_trace_host(const int32_t* l0_occ, const int32_t* l0_mixed,
                             const int32_t* l0_sc, const int32_t* brick_slot,
                             const int32_t* occ_words,
                             const int32_t* sc_words, int G,
                             int l0_coarse_base, int zw, int pages,
                             const float* origins, const float* dirs,
                             const uint8_t* alive, const int64_t* order,
                             int n, int* counter, int32_t* status, float* t,
                             int32_t* cell, int32_t* widx, int32_t* iters) {
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  const Records out = {status, t, cell, widx, iters};
  run_warps(T, n, counter, out, [&](int k, wf::RayState* s) {
    const int r = order ? (int)order[k] : k;
    if (!alive[r]) {
      out.put(wf::miss_record(), r);
      return -1;
    }
    const float* o = origins + 3 * (size_t)r;
    const float* d = dirs + 3 * (size_t)r;
    *s = wf::start_ray(o[0], o[1], o[2], d[0], d[1], d[2]);
    return r;
  });
  return 0;
}

extern "C" int wf_trace_camera_host(
    const int32_t* l0_occ, const int32_t* l0_mixed, const int32_t* l0_sc,
    const int32_t* brick_slot, const int32_t* occ_words,
    const int32_t* sc_words, int G, int l0_coarse_base, int zw, int pages,
    const float* cam, int W, int H, int nbx, int world_size, int n,
    int* counter, int32_t* status, float* t, int32_t* cell, int32_t* widx,
    int32_t* iters) {
  const wf::Tables T = wf::make_tables(l0_occ, l0_mixed, l0_sc, brick_slot,
                                       occ_words, sc_words, G,
                                       l0_coarse_base, zw, pages);
  const wf::Camera C = {cam, W, H, nbx, (float)world_size};
  const Records out = {status, t, cell, widx, iters};
  run_warps(T, n, counter, out, [&](int k, wf::RayState* s) {
    *s = wf::start_camera_ray(C, k);
    return k;
  });
  return 0;
}

extern "C" int wf_ray_keys_host(const float* origins, const float* dirs,
                                const uint8_t* alive, int n, int G,
                                int32_t* keys) {
  for (int i = 0; i < n; ++i) {
    keys[i] = wf::ray_key(origins[3 * i], origins[3 * i + 1],
                          origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1],
                          dirs[3 * i + 2], alive[i] != 0, G);
  }
  return 0;
}
