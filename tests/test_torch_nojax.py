"""The port never imports jax or the JAX package: with both blocked in
sys.modules, every svo_raytracer_torch module imports, a few rays trace on
the CPU, chip_smoke.py's scene and camera helpers run, and a 32^3
heightmap octree built by the port renders a mode-2 frame with a skip
grid through chip_smoke's ESVO world helper."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
for blocked in ("jax", "svo_raytracer_tpu"):
    sys.modules[blocked] = None    # importing it now raises ImportError
sys.path.insert(0, sys.argv[1])
import pkgutil, importlib, torch
import svo_raytracer_torch
for m in pkgutil.walk_packages(svo_raytracer_torch.__path__,
                               "svo_raytracer_torch."):
    importlib.import_module(m.name)
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import wavefront
hm, mm = bigworld.fractal_heightmap(64, seed=0)
ws = wavefront.prepare(bigworld.heightmap_brick_scene(hm, mm, 64), "cpu")
o = torch.tensor([[1.5, 1.9, 1.5], [1.1, 1.9, 1.7]])
d = torch.tensor([[0.0, -1.0, 0.0], [0.3, -1.0, 0.1]])
res = wavefront.intersect_wavefront(ws, o, d / d.norm(dim=1, keepdim=True))
assert res.hit.all(), res
import chip_smoke
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.ops import brick_scene
tree = build_np.build_octree_np(chip_smoke.sphere_voxels(32, 12))
ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
cam5 = chip_smoke.place_camera(ws, "cpu")
assert cam5.shape == (5, 3) and 1.0 < float(cam5[0, 1]) < 2.0, cam5
from svo_raytracer_torch.ops import shade
hm, mm = bigworld.fractal_heightmap(32, seed=1)
etree, packed, tabs = chip_smoke.build_esvo_world(torch.device("cpu"), hm,
                                                  mm, 32)
assert etree.n_nodes > 8 and tabs[32].shape == (8, 128) and 64 in tabs
col, depth, _ = shade.render_image(etree, cam5, 32, 24, render_mode=2,
                                   packed=packed, skip_tab=tabs[32])
assert col.shape == (24, 32, 3) and bool(torch.isfinite(col).all())
assert 0.0 < float((depth > 0).float().mean()) < 1.0, depth
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
