"""The port never imports jax or the JAX package: with both blocked in
sys.modules, every svo_raytracer_torch module imports, a few rays trace on
the CPU through the wavefront engine and through the v1 brick engine
(brick_pallas), chip_smoke.py's scene helpers and the bench's probe
camera run, a wavefront mode-2 frame renders with camera-mode primaries,
a 32^3 heightmap octree built by the port renders a mode-2 frame with a
skip grid through chip_smoke's ESVO world helper, a 32^3 perlin world
builds from 16^3 chunks through models/world.build_world, a wavefront
K-hit train step (the two walls, K = 2) and a render_diff train step (on
that octree) run, the bench's small pipeline (64^3, one warm and one
timed frame) runs on the CPU, and apps/worldgen writes a 32^3 world that
apps/viewer opens and edits through each engine (two edits, a
screenshot, save and re-read); then the entry's analog renders its
frame, a staged ESVO frame with a skip grid equals render_image's, a
threefry progressive frame renders, and the XLA brick engine
(brick_trace.intersect_bricks) traces rays as the wavefront engine
does.  The multi-process layer (svo_raytracer_torch.parallel) imports
with them, and ``python -m svo_raytracer_torch.entry --multichip 2
--cpu`` runs dryrun_multichip in two spawned ranks with jax and the JAX
package unimportable in every process."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
for blocked in ("jax", "svo_raytracer_tpu"):
    sys.modules[blocked] = None    # importing it now raises ImportError
sys.path.insert(0, sys.argv[1])
import os, pkgutil, importlib, torch
import svo_raytracer_torch
for m in pkgutil.walk_packages(svo_raytracer_torch.__path__,
                               "svo_raytracer_torch."):
    importlib.import_module(m.name)
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import wavefront
hm, mm = bigworld.fractal_heightmap(64, seed=0)
scene64 = bigworld.heightmap_brick_scene(hm, mm, 64)
ws = wavefront.prepare(scene64, "cpu")
o = torch.tensor([[1.5, 1.9, 1.5], [1.1, 1.9, 1.7]])
d = torch.tensor([[0.0, -1.0, 0.0], [0.3, -1.0, 0.1]])
res = wavefront.intersect_wavefront(ws, o, d / d.norm(dim=1, keepdim=True))
assert res.hit.all(), res
from svo_raytracer_torch.ops import brick_pallas, render_wave
res3 = brick_pallas.intersect_bricks_tpu(scene64.to_device("cpu"), o,
                                         d / d.norm(dim=1, keepdim=True))
assert res3.hit.all() and torch.equal(res3.value, res.value), res3
import chip_smoke
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.ops import brick_scene
tree = build_np.build_octree_np(chip_smoke.sphere_voxels(32, 12))
ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
from svo_raytracer_torch import bench
cam5, _ = bench.place_camera(ws)
assert cam5.shape == (5, 3) and 1.0 < float(cam5[0, 1]) < 2.0, cam5
stats = []
col, depth, _ = render_wave.render_frame_wavefront(ws, cam5, 32, 24,
                                                   render_mode=2, stats=stats)
assert bool(torch.isfinite(col).all()) and stats[0]["camera"], stats
from svo_raytracer_torch.ops import shade
hm, mm = bigworld.fractal_heightmap(32, seed=1)
etree, packed, tabs = chip_smoke.build_esvo_world(torch.device("cpu"), hm,
                                                  mm, 32)
assert etree.n_nodes > 8 and tabs[32].shape == (8, 128) and 64 in tabs
col, depth, _ = shade.render_image(etree, cam5, 32, 24, render_mode=2,
                                   packed=packed, skip_tab=tabs[32])
assert col.shape == (24, 32, 3) and bool(torch.isfinite(col).all())
assert 0.0 < float((depth > 0).float().mean()) < 1.0, depth
from svo_raytracer_torch.models import procgen, world
w32 = world.build_world(32, 16, lambda o: procgen.generate_chunk(
    o, 16, device="cpu"), world_offset=(0, -16, 0))
assert w32.n_nodes > 8 + 8 * 8 and w32.child.device.type == "cpu", w32
assert 0 < int(w32.child.max()) < w32.n_nodes
bench.WARM_FRAMES = bench.TIMED_FRAMES = 1
from svo_raytracer_torch.diff import checkpoint, render_diff, wave_diff
ws2 = wavefront.prepare(brick_scene.brickify(build_np.build_octree_np(
    chip_smoke.two_wall_voxels())), "cpu")
W2, H2 = chip_smoke.TWO_WALL_FRAME
step = wave_diff.make_wave_train_step(ws2, W2, H2, K=2, lr=400.0)
p, loss = step(wave_diff.init_params(ws2, 4.0),
               torch.from_numpy(chip_smoke.two_wall_camera()),
               torch.zeros(H2, W2, 3))
assert bool(torch.isfinite(loss)) and bool((p.density != 4.0).any()), loss
v0 = render_diff.init_params(etree)
target = 0.8 * render_diff.render_diff(v0, etree, cam5, 32, 24,
                                      packed=packed)
v, loss = render_diff.train_step(v0, etree, cam5, target, 32, 24, lr=300.0,
                                 packed=packed)
assert bool(torch.isfinite(loss)) and not torch.equal(v.albedo, v0.albedo)
assert checkpoint.KINDS["wave"] is wave_diff.WaveParams
rows = []
bench.run(64, 64, 64, 40, "cpu", emit=rows.append)
assert len(rows) == 2 and rows[1]["n_left"] == dict(prim=0, gi1=0, gi2=0,
                                                     gi3=0), rows
import tempfile
from svo_raytracer_torch.apps import viewer, worldgen
from svo_raytracer_torch.core import svo_format
d = tempfile.mkdtemp()
w, _ = worldgen.main(["--size", "32", "--chunk", "16", "--cpu", "--out",
                      d + "/w.svo"])
assert svo_format.read_svo_file(d + "/w.svo", 32).n_nodes == w.n_nodes
for engine in ("wavefront", "esvo"):
    v = viewer.main(["--svo", d + "/w.svo", "--world-size", "32", "--cpu",
                     "--width", "32", "--height", "24", "--out", d,
                     "--engine", engine, "--script", "3 c x p 0 9 Q"])
    assert len(v.edits) == 2 and os.path.exists(d + "/level1.svo")
    assert v.tree_host.n_nodes >= w.n_nodes, v.edits
from svo_raytracer_torch import entry
from svo_raytracer_torch.ops import brick_trace, rng
fn, args = entry.entry("cpu")
out = fn(*args)
assert tuple(out.shape) == (144, 256, 3) and bool(torch.isfinite(out).all())
col, depth, _ = shade.render_frame_staged(etree, cam5, 32, 24,
                                          render_mode=2, packed=packed,
                                          use_beam=False,
                                          skip_tab=tabs[32])
assert col.shape == (24, 32, 3) and bool(torch.isfinite(col).all())
assert torch.equal(col, shade.render_image(
    etree, cam5, 32, 24, render_mode=2, packed=packed,
    skip_tab=tabs[32])[0])
col, depth = shade.render_progressive(etree, cam5, 16, 12, spp=2,
                                      rng_key=rng.prng_key(1))
assert col.shape == (12, 16, 3) and bool(torch.isfinite(col).all())
bo = torch.tensor([[1.5, 1.9, 1.5], [1.1, 1.9, 1.7]])
bd = torch.tensor([[0.0, -1.0, 0.0], [0.3, -1.0, 0.1]])
bd = bd / bd.norm(dim=1, keepdim=True)
res = brick_trace.intersect_bricks(scene64.to_device("cpu"), bo, bd)
assert res.hit.all() and torch.equal(
    res.value, wavefront.intersect_wavefront(wavefront.prepare(
        scene64, "cpu"), bo, bd).value), res
assert not any(k.split(".")[0] in ("jax", "svo_raytracer_tpu")
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_port_imports_and_traces_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, ROOT],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


BLOCKERS = ("jax", "svo_raytracer_tpu")


def test_multichip_launcher_runs_without_jax(tmp_path):
    """Packages named jax and svo_raytracer_tpu that raise on import, first
    on the path of the launcher and of the ranks it spawns (they inherit
    its sys.path); the repository comes after them."""
    for name in BLOCKERS:
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
         "import svo_raytracer_torch.parallel.bricks, "
         "svo_raytracer_torch.parallel.render_wave_sharded, "
         "svo_raytracer_torch.parallel.distributed; "
         "from svo_raytracer_torch import entry; "
         "entry.main(['--multichip', '2', '--cpu'])",
         str(tmp_path), ROOT],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 4 and all(x.startswith("dryrun_multichip(2): ")
                                   for x in lines), proc.stdout
    assert "n_left=0" in lines[2] and "k-hit train step" in lines[3]
