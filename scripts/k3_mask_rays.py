#!/usr/bin/env python3
"""The primaries where K3's mode-2 hit mask differs from the wavefront
frame's, traced on the CPU through both engines of the JAX package and
of the port.

chip_smoke.py's K3 phase writes those pixels to
svo_raytracer_torch/_build/k3_mask_rays.npz: their ids, the rays K3's frame traced
(shade.pixel_dirs_device, normalized), K3's hit and depth, the
wavefront frame's depth, and the camera.  The wavefront frame traced
each pixel along the camera-mode ray (render_wave._frame_rays, its own
rounding).  This script rebuilds the world from its seed (the port's
bigworld.fractal_heightmap, the JAX package's and the port's
heightmap_brick_scene, which must agree word for word) and traces both
ray sets through

  * the JAX package's brick_pallas.intersect_bricks_tpu (interpret
    mode) and wavefront.intersect_wavefront (interpret mode);
  * the port's brick_pallas.intersect_bricks_tpu and
    wavefront.intersect_wavefront (their plain versions on the CPU),

then prints per pixel each engine's hit and t, and a verdict: where the
JAX package's two engines also disagree on the same rays, the
difference is the reference's own; where they agree and a port engine
does not, it is a port fault.

    env JAX_PLATFORMS=cpu python3 scripts/k3_mask_rays.py \\
        [svo_raytracer_torch/_build/k3_mask_rays.npz]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from svo_raytracer_tpu.models import bigworld as jbigworld  # noqa: E402
from svo_raytracer_tpu.ops import brick_pallas as jbrick_pallas  # noqa: E402
from svo_raytracer_tpu.ops import wavefront as jwavefront  # noqa: E402
from svo_raytracer_torch.models import bigworld  # noqa: E402
from svo_raytracer_torch.ops import brick_pallas, render_wave  # noqa: E402
from svo_raytracer_torch.ops import wavefront  # noqa: E402


def camera_rays(cam5, width, height, pixels):
    """The wavefront frame's camera-mode rays of the given row-major
    pixel ids (render_wave._frame_rays' arithmetic)."""
    o, d, px, py = render_wave._frame_rays(torch.from_numpy(cam5), width,
                                           height)
    ids = (py.long() * width + px.long()).numpy()
    real = py.numpy() < height
    where = {int(i): k for k, i in enumerate(ids) if real[k]}
    rows = np.asarray([where[int(p)] for p in pixels], np.int64)
    return o.numpy()[rows], d.numpy()[rows]


def engines(jscene, jws, scene, ws, o, d):
    """{engine: (hit, t)} of the four engines on (n,3) world rays, and of
    both K3s given 96 rounds (intersect_bricks_tpu's default is 24)."""
    out = {}
    r = jbrick_pallas.intersect_bricks_tpu(jscene, jnp.asarray(o),
                                           jnp.asarray(d), interpret=True)
    out["JAX K3"] = (np.asarray(r.hit), np.asarray(r.t))
    r = jwavefront.intersect_wavefront(jws, jnp.asarray(o), jnp.asarray(d),
                                       interpret=True)
    out["JAX wavefront"] = (np.asarray(r.hit), np.asarray(r.t))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    r = brick_pallas.intersect_bricks_tpu(scene, ot, dt)
    out["port K3"] = (r.hit.numpy(), r.t.numpy())
    r = jbrick_pallas.intersect_bricks_tpu(jscene, jnp.asarray(o),
                                           jnp.asarray(d), max_rounds=96,
                                           interpret=True)
    out["JAX K3 96 rounds"] = (np.asarray(r.hit), np.asarray(r.t))
    r = brick_pallas.intersect_bricks_tpu(scene, ot, dt, max_rounds=96)
    out["port K3 96 rounds"] = (r.hit.numpy(), r.t.numpy())
    r = wavefront.intersect_wavefront(ws, ot, dt)
    out["port wavefront"] = (r.hit.numpy(), r.t.numpy())
    return out


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "svo_raytracer_torch", "_build", "k3_mask_rays.npz")
    z = np.load(path)
    size, seed = int(z["world_size"]), int(z["seed"])
    width, height = int(z["width"]), int(z["height"])
    pixels = z["pixel"]
    print(f"{len(pixels)} pixels of a {width}x{height} frame, {size}^3 "
          f"world, seed {seed}", flush=True)
    t0 = time.time()
    hm, mm = bigworld.fractal_heightmap(size, seed=seed)
    jscene = jbigworld.heightmap_brick_scene(hm, mm, size)
    scene = bigworld.heightmap_brick_scene(hm, mm, size)
    for f in scene.ARRAYS:
        assert np.array_equal(np.asarray(getattr(jscene, f)),
                              np.asarray(getattr(scene, f))), f
    jdev, jws = jscene.to_device(), jwavefront.prepare(jscene)
    dscene, ws = scene.to_device("cpu"), wavefront.prepare(scene, "cpu")
    print(f"world built in {time.time() - t0:.1f} s; the JAX package's and "
          f"the port's tables equal", flush=True)
    sets = {"K3 frame's rays": (z["origins"], z["dirs"]),
            "wavefront frame's rays": camera_rays(z["cam5"], width, height,
                                                  pixels)}
    o1, d1 = sets["K3 frame's rays"]
    o2, d2 = sets["wavefront frame's rays"]
    print(f"origins equal {np.array_equal(o1, o2)}; directions differ on "
          f"{int((d1 != d2).any(1).sum())} of {len(pixels)} rays, max "
          f"|dd| {float(np.abs(d1 - d2).max()) if len(pixels) else 0:.3e}")
    res = {}
    for name, (o, d) in sets.items():
        t0 = time.time()
        res[name] = engines(jdev, jws, dscene, ws, o.astype(np.float32),
                            d.astype(np.float32))
        print(f"{name}: traced in {time.time() - t0:.1f} s", flush=True)
    print("pixel (x, y): frame hits K3 / wavefront | K3 frame's rays: "
          "JAX K3, JAX wavefront, port K3, JAX K3 and port K3 with 96 "
          "rounds, port wavefront | wavefront frame's rays: the same six "
          "(hit 1/0, t)")
    tally = dict(jax_engines_disagree=0, port_fault=0, rays_differ=0,
                 jax_96_rounds_miss=0, jax_lost_rounds_in_bins=0)
    for k, p in enumerate(pixels):
        cells = []
        for name in sets:
            cells.append(", ".join(
                f"{int(h[k])} {t[k]:.6f}" for h, t in res[name].values()))
        a = res["K3 frame's rays"]
        b = res["wavefront frame's rays"]
        jax_split = a["JAX K3"][0][k] != a["JAX wavefront"][0][k]
        port_off = (a["port K3"][0][k] != a["JAX K3"][0][k]
                    or a["port K3 96 rounds"][0][k]
                    != a["JAX K3 96 rounds"][0][k]
                    or b["port wavefront"][0][k] != b["JAX wavefront"][0][k])
        tally["jax_96_rounds_miss"] += int(not a["JAX K3 96 rounds"][0][k])
        tally["jax_engines_disagree"] += int(jax_split)
        tally["port_fault"] += int(port_off)
        tally["rays_differ"] += int(a["JAX K3"][0][k]
                                    != b["JAX K3"][0][k])
        print(f"  {int(p) % width:4d} {int(p) // width:4d}: "
              f"{int(z['k3_hit'][k])} / {int(z['wave_depth'][k] > 0)} | "
              f"{cells[0]} | {cells[1]}")
    # JAX's K3 bins its rays by brick each round and a ray that overflows
    # its bin's padding waits a round; traced alone, no ray waits
    a = res["K3 frame's rays"]
    split = np.nonzero(a["JAX K3 96 rounds"][0]
                       != a["port K3 96 rounds"][0])[0]
    for k in split:
        r = jbrick_pallas.intersect_bricks_tpu(
            jdev, jnp.asarray(o1[k:k + 1]), jnp.asarray(d1[k:k + 1]),
            max_rounds=96, interpret=True)
        alone = bool(r.hit[0]) == bool(a["port K3 96 rounds"][0][k])
        tally["port_fault"] -= int(alone)
        tally["jax_lost_rounds_in_bins"] += int(alone)
        print(f"  pixel {int(pixels[k])}: JAX's K3 with 96 rounds on this "
              f"ray alone: hit {bool(r.hit[0])} t {float(r.t[0]):.6f} "
              f"(port {bool(a['port K3 96 rounds'][0][k])} "
              f"{float(a['port K3 96 rounds'][1][k]):.6f})")
    ot, dt = torch.from_numpy(o1), torch.from_numpy(d1)
    for rounds in (24, 48, 96, 192, 400, 1000):
        r = brick_pallas.intersect_bricks_tpu(dscene, ot, dt,
                                              max_rounds=rounds)
        h = r.hit.numpy()
        same_t = bool((np.abs(r.t.numpy()[h] - z["wave_depth"][h])
                       <= 1e-6).all())
        print(f"  the port's K3 with {rounds} rounds: {int(h.sum())} of "
              f"{len(pixels)} hit, each at the wavefront frame's depth "
              f"(1e-6) {same_t}; DDA steps up to {int(r.iters.max())}")
    print(f"[verdict] of {len(pixels)} pixels: the JAX package's two "
          f"engines disagree on the K3 frame's ray at "
          f"{tally['jax_engines_disagree']}; a port engine differs from its "
          f"JAX counterpart at {tally['port_fault']} (and where JAX's K3, "
          f"in a batch, lost rounds to its bins' padding at "
          f"{tally['jax_lost_rounds_in_bins']}); JAX's K3 answers the "
          f"two frames' rays differently at {tally['rays_differ']}; JAX's "
          f"K3 still misses the K3 frame's ray with 96 rounds at "
          f"{tally['jax_96_rounds_miss']}")


if __name__ == "__main__":
    main()
