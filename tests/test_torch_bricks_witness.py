"""Which engine is right where K1 and the brick reference engine part.

chip_smoke.py's [bricks] phase holds K1 (wavefront.intersect_wavefront)
against brick_trace.intersect_bricks on 131,072 rays of the bench world
(1024^3 perlin terrain, bench.py's probe camera: sampled 1080p primaries
and gi-1 bounce rays) on the card.  Where the two part it asks a third
witness that reads the world from its generator, and
tests/data/bench_world_bricks_disputed.npz keeps the rays that parted in
one run with both engines' answers (hit, t in voxels).  Here:

  * each of those rays is walked again in exact rational arithmetic over
    the bench world's voxels (the perlin noise evaluated on the CPU,
    which equals the card's, tests/test_torch_worldgen.py), and each
    engine's answer is held to chip_smoke.brick_witness's rule: it passes
    no solid voxel that the ray crosses for BRICK_DT_VOX (0.0105) voxels
    or more, and a hit lies within BRICK_DT_VOX of a solid voxel.  K1 is
    right on every ray.  The oracle is right on every ray but its misses
    of rays that lie in a brick-face plane with a direction component
    under the engines' 1e-4 clamp;
  * the two design limits behind the parting, on a 64^3 world, in the
    JAX package's engines and the port's alike: K1 (both K1s) steps over
    a voxel that a ray clips for less than its 1e-2-voxel brick-exit
    nudge just past a brick face, which both brick_trace engines hit; and
    both brick_trace engines miss a ray that lies in a brick-face plane
    with a direction component under the clamp, which both K1s hit (the
    oracle's 1/1024-voxel exit nudge along that component moves the
    origin by less than a float32 ulp, so it re-enters the brick it left
    until its 64 rounds run out).
"""

import math
import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BRICK_DT_VOX
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.ops import brick_scene, brick_trace, noise
from svo_raytracer_torch.ops import wavefront

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "bench_world_bricks_disputed.npz")
BENCH_SIZE = 1024
TOL = Fraction(BRICK_DT_VOX)
DIR_EPS = Fraction(float(np.float32(1e-4)))


def _exact_ray(o_world, d, world_size):
    """Voxel-unit origin and the engines' clamped direction, as exact
    rationals of the float32 inputs."""
    o = [(Fraction(float(v)) - 1) * world_size for v in o_world]
    dd = []
    for v in d:
        v = Fraction(float(v))
        dd.append(v if abs(v) >= DIR_EPS else (DIR_EPS if v >= 0
                                               else -DIR_EPS))
    return o, dd


def _walk(o, d, world_size, t_stop):
    """The voxels the ray crosses up to ``t_stop`` (or the world's edge),
    as (voxel, t_in, t_out), exactly."""
    idx = []
    for p, v in zip(o, d):
        f = math.floor(p)
        idx.append(f - 1 if p == f and v < 0 else f)
    t, cells = Fraction(0), []
    while all(0 <= i < world_size for i in idx) and t <= t_stop:
        nxt = [((i + (v > 0)) - p) / v for i, p, v in zip(idx, o, d)]
        t_out = min(nxt)
        cells.append((tuple(idx), t, t_out))
        for a in range(3):
            if nxt[a] == t_out:
                idx[a] += 1 if d[a] > 0 else -1
        t = t_out
    return cells


def _judge(o, d, hit, t, cells, solid):
    """chip_smoke.brick_witness's rule in exact arithmetic: (right,
    passed a clip)."""
    crossed = [(a, b) for v, a, b in cells if solid[v]]
    limit = t - TOL if hit else None
    real = [a for a, b in crossed if b - a >= TOL]
    if not hit:
        return not real, False
    passed = any(a < limit for a, b in crossed)
    if real and real[0] < limit:
        return False, passed
    p = [oi + t * di for oi, di in zip(o, d)]
    base = [math.floor(x) for x in p]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                v = (base[0] + dx, base[1] + dy, base[2] + dz)
                dist = max(max(v[a] - p[a], p[a] - (v[a] + 1), 0)
                           for a in range(3))
                if dist <= TOL and solid.get(v, False):
                    return True, passed
    return False, passed


def _bench_solid(voxels):
    v = torch.tensor(sorted(voxels), dtype=torch.int32).reshape(-1, 3)
    s = noise.sample_perlin_terrain(v[:, 0], v[:, 1] - BENCH_SIZE // 2,
                                    v[:, 2])
    return dict(zip(map(tuple, v.tolist()), s.bool().tolist()))


def test_disputed_bench_rays_decided_exactly():
    z = np.load(DATA)
    n = len(z["index"])
    rays = []
    for i in range(n):
        o, d = _exact_ray(z["o"][i], z["d"][i], BENCH_SIZE)
        ans = {e: (bool(z[f"{e}_hit"][i]),
                   Fraction(float(z[f"{e}_t_vox"][i])))
               for e in ("k1", "ref")}
        t_stop = max(t for h, t in ans.values() if h) + 2
        rays.append((o, d, ans, _walk(o, d, BENCH_SIZE, t_stop)))
    need = set()
    for o, d, ans, cells in rays:
        need.update(v for v, _, _ in cells)
        for h, t in ans.values():
            if h:
                base = [math.floor(oi + t * di) for oi, di in zip(o, d)]
                need.update((base[0] + a, base[1] + b, base[2] + c)
                            for a in (-1, 0, 1) for b in (-1, 0, 1)
                            for c in (-1, 0, 1))
    solid = _bench_solid({v for v in need
                          if all(0 <= x < BENCH_SIZE for x in v)})
    k1_passed, stuck = 0, 0
    for i, (o, d, ans, cells) in enumerate(rays):
        right, passed = _judge(o, d, *ans["k1"], cells, solid)
        assert right, f"K1 wrong on ray {z['index'][i]}"
        k1_passed += passed
        right, _ = _judge(o, d, *ans["ref"], cells, solid)
        if not right:
            in_plane = [o[a] % 32 == 0 and abs(d[a]) == DIR_EPS
                        for a in range(3)]
            assert not ans["ref"][0] and any(in_plane), \
                f"oracle wrong on ray {z['index'][i]}"
            stuck += 1
    print(f"{n} rays: K1 right on all ({k1_passed} past a clip), the "
          f"oracle right on {n - stuck}, stuck in a brick-face plane on "
          f"{stuck}")
    assert n > 0 and k1_passed > 0 and stuck > 0


def _world_64(solid_voxels):
    vox = np.zeros((64, 64, 64), np.uint8)
    for v in solid_voxels:
        vox[v] = 1
    tree = build_np.build_octree_np(vox)
    return jbrick_scene.brickify(tree), brick_scene.brickify(tree)


def _engines(jscene, scene, o_vox, d):
    """Hit and t (voxels) of (JAX K1, port K1, JAX oracle, port oracle)
    on float32 voxel-unit rays of the 64^3 world."""
    o = (np.asarray(o_vox, np.float32) / np.float32(64) + np.float32(1))
    d = np.asarray(d, np.float32)
    out = [jwavefront.intersect_wavefront(jwavefront.prepare(jscene),
                                          jnp.asarray(o), jnp.asarray(d),
                                          interpret=True),
           wavefront.intersect_wavefront(wavefront.prepare(scene, "cpu"),
                                         torch.from_numpy(o),
                                         torch.from_numpy(d)),
           jbrick_trace.intersect_bricks(jscene, jnp.asarray(o),
                                         jnp.asarray(d)),
           brick_trace.intersect_bricks(scene.to_device("cpu"),
                                        torch.from_numpy(o),
                                        torch.from_numpy(d))]
    return o, [(np.asarray(r.hit), np.asarray(r.t) * 64) for r in out]


@pytest.mark.parametrize("y0,skipped", [(10.996, True), (10.98, False)])
def test_k1_steps_over_a_clip_past_a_brick_face(y0, skipped):
    """A ray rising at 0.5 y per x through brick (0, 0, 0), which holds
    a solid voxel off its path, leaves it across the brick face x = 32 at
    y = ``y0`` and clips solid voxel (32, 10, 10) until y = 11: for
    0.0089 voxels at y0 = 10.996 (under K1's 1e-2 nudge past the face of
    the mixed brick it leaves: both K1s step over it and miss), for 0.045
    at 10.98 (all four engines hit it)."""
    jscene, scene = _world_64([(32, 10, 10), (5, 30, 30)])
    d = np.array([[1.0, 0.5, 0.0]]) / math.sqrt(1.25)
    o_vox = [[20.0, y0 - 6.0, 10.5]]
    o, res = _engines(jscene, scene, o_vox, d)
    ro, rd = _exact_ray(o[0], d[0].astype(np.float32), 64)
    cells = _walk(ro, rd, 64, Fraction(64))
    chord = [b - a for v, a, b in cells if v == (32, 10, 10)][0]
    assert (chord < TOL) == skipped
    for h, t in res[2:]:     # the brick_trace engines hit it
        assert h[0] and abs(t[0] - 12 * math.sqrt(1.25)) < 0.05
    for h, _ in res[:2]:
        assert h[0] == (not skipped)


def test_oracle_stuck_in_a_brick_face_plane():
    """A ray from the brick face x = 32 whose x component (-1e-8) the
    engines clamp to -1e-4, rising in y and z to solid voxel (31, 11, 13)
    ~10.5 voxels away, with brick (1, 0, 0) beyond the face mixed (solid
    voxel (40, 5, 5), off the path): both K1s hit the voxel, both
    brick_trace engines run out of rounds and miss."""
    jscene, scene = _world_64([(31, 11, 13), (40, 5, 5)])
    d = np.array([[-1e-8, 0.6, 0.8]])
    o, res = _engines(jscene, scene, [[32.0, 5.0, 5.0]], d)
    ro, rd = _exact_ray(o[0], d[0].astype(np.float32), 64)
    cells = _walk(ro, rd, 64, Fraction(64))
    hit = [(a, b) for v, a, b in cells if v == (31, 11, 13)]
    assert hit and hit[0][1] - hit[0][0] >= TOL
    for h, t in res[:2]:
        assert h[0] and abs(t[0] - float(hit[0][0])) <= BRICK_DT_VOX
    for h, _ in res[2:]:
        assert not h[0]
