"""Port traversal (svo_raytracer_torch intersect_wavefront, run on the CPU
through trace_plain, kernel K1's plain version) vs the JAX package's
intersect_wavefront (Pallas kernel in interpret mode) and its XLA oracle
brick_trace.intersect_bricks, on the same seeded rays.

Floors are tests/test_wavefront.py::_compare's: hit agreement >= 0.995,
strict fields >= 0.98.  Measured on this port: 1.0 and 1.0 on every case,
with equal iteration counts on every ray against intersect_wavefront
(intersect_bricks counts fine steps, so its iters differ by design)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.models import bigworld as jbigworld
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.models import bigworld
from svo_raytracer_torch.ops import brick_scene, wavefront
from test_traverse_batch import random_rays


def _scene(name):
    if name == "heightmap-512":
        # raised floor: uniform-stone bricks; empty upper half: supercell jumps
        hm, mm = bigworld.fractal_heightmap(512, seed=3, lo=0.3, hi=0.9)
        return (jbigworld.heightmap_brick_scene(hm, mm, 512),
                bigworld.heightmap_brick_scene(hm, mm, 512))
    vox = (make_sphere_voxels(64, radius=24) if name == "sphere-64"
           else make_terrain_voxels(64, seed=7))
    tree = build_np.build_octree_np(vox)
    return jbrick_scene.brickify(tree), brick_scene.brickify(tree)


CASES = {"sphere-64": (192, 11), "terrain-64": (192, 12),
         "heightmap-512": (384, 5)}


@pytest.fixture(scope="module")
def traced():
    """Per case: (port HitResult, JAX wavefront HitResult, oracle)."""
    out = {}
    for name, (n, seed) in CASES.items():
        jscene, scene = _scene(name)
        o, d = random_rays(n, seed=seed)
        got = wavefront.intersect_wavefront(
            wavefront.prepare(scene, "cpu"), torch.from_numpy(o),
            torch.from_numpy(d))
        wf = jwavefront.intersect_wavefront(
            jwavefront.prepare(jscene), jnp.asarray(o), jnp.asarray(d),
            interpret=True)
        oracle = jbrick_trace.intersect_bricks(jscene, jnp.asarray(o),
                                               jnp.asarray(d))
        out[name] = ({k: v.numpy() for k, v in got._asdict().items()},
                     {k: np.asarray(v) for k, v in wf._asdict().items()},
                     {k: np.asarray(v) for k, v in oracle._asdict().items()})
    return out


def _agreement(ref, got):
    """(hit agreement, strict-field share on shared hits, iters-equal
    share) — the field tests of tests/test_wavefront.py::_compare."""
    agree = (ref["hit"] == got["hit"]).mean()
    both = ref["hit"] & got["hit"]
    strict = np.ones(ref["hit"].shape[0], bool)
    strict &= ~both | (ref["value"] == got["value"])
    strict &= ~both | (ref["depth"] == got["depth"])
    strict &= ~both | (np.abs(ref["t"] - got["t"]) <= 2e-4)
    strict &= ~both | (np.abs(ref["normal"] - got["normal"]).max(-1) <= 1e-5)
    return agree, strict[both].mean(), (ref["iters"] == got["iters"]).mean()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("reference", ["intersect_wavefront",
                                       "intersect_bricks"])
def test_traversal_matches_reference(traced, case, reference):
    got, wf, oracle = traced[case]
    ref = wf if reference == "intersect_wavefront" else oracle
    agree, strict, iters_eq = _agreement(ref, got)
    print(f"{case} vs {reference}: hit agreement {agree:.4f}, strict "
          f"{strict:.4f}, equal iters {iters_eq:.4f}")
    assert got["hit"].any() and not got["hit"].all()
    assert agree >= 0.995, f"hit agreement {agree}"
    assert strict >= 0.98, f"strict {strict}"


@pytest.mark.parametrize("case", list(CASES))
def test_node_and_iters_match_wavefront(traced, case):
    """node (the attr_comb index) and the coarse-step count are the JAX
    engine's own fields: equal on every ray."""
    got, wf, _ = traced[case]
    assert got["node"].dtype == np.int32
    assert np.array_equal(got["node"], wf["node"])
    assert np.array_equal(got["iters"], wf["iters"])


def test_active_mask_and_nan():
    tree = build_np.build_octree_np(make_sphere_voxels(64, radius=24))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    o = np.array([[0.5, 1.5, 1.5], [np.nan, 1.5, 1.5], [0.5, 1.5, 1.5]],
                 np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (3, 1))
    act = torch.tensor([True, True, False])
    res = wavefront.intersect_wavefront(ws, torch.from_numpy(o),
                                        torch.from_numpy(d), active=act)
    assert res.hit.tolist() == [True, False, False]
    assert res.node.tolist()[1:] == [-1, -1]
    jres = jwavefront.intersect_wavefront(
        jwavefront.prepare(jbrick_scene.brickify(tree)), jnp.asarray(o),
        jnp.asarray(d), active=jnp.asarray(act.numpy()), interpret=True)
    assert np.array_equal(np.asarray(jres.hit), res.hit.numpy())
    assert float(res.t[0]) == float(jres.t[0])


def test_cuda_tensors_never_take_the_plain_path():
    """A non-CPU tensor goes to the kernel wrapper, which rejects what it
    cannot launch; only CPU tensors reach trace_plain."""
    tree = build_np.build_octree_np(make_sphere_voxels(64, radius=24))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        wavefront.trace(ws, o, o, torch.ones(4, dtype=torch.bool,
                                             device="meta"))
