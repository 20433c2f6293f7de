"""The port's ESVO traversal on the CPU (its plain version,
traverse.intersect_plain) against the JAX package's intersect_octree and
the scalar oracle traverse_ref.

The contract is JAX's own check_parity (tests/test_traverse_batch.py):
hit masks agree on every ray, and at least 98% of rays agree strictly on
value, node, t (1e-4), scale_exp2, depth, normal (1e-5) and voxel_pos
(1e-4), with iteration counts within 2.  XLA contracts multiply-adds that
the port does not form, so JAX is not bit-equal; the oracle rounds each
operation as the port does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_sphere_voxels, make_terrain_voxels
from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import traverse as jtraverse
from svo_raytracer_tpu.ops import traverse_ref
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import traverse
from test_traverse_batch import random_rays

MIN_STRICT = 0.98
ORACLE_RAYS = 192


def _port_tree(jt):
    return octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, vox in (("sphere-64", make_sphere_voxels(64, radius=24)),
                      ("terrain-64", make_terrain_voxels(64, seed=7)),
                      ("checker-16", (np.indices((16,) * 3).sum(0) % 2)
                       .astype(np.uint8))):
        jt = build_np.build_octree_np(vox)
        out[name] = (jt, _port_tree(jt))
    return out


def _np(res):
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _oracle(jt, o, d, **kw):
    rs = [traverse_ref.intersect_octree(jt, o[i], d[i], **kw)
          for i in range(o.shape[0])]
    return {f: np.array([getattr(r, f) for r in rs]) for f in
            ("hit", "value", "t", "iters", "scale_exp2", "depth", "normal",
             "voxel_pos", "node")}


def _agreement(ref, got):
    """(hit mask equal on every ray, strict fraction) under check_parity."""
    hit_eq = ref["hit"] == got["hit"]
    ok = np.abs(ref["iters"].astype(np.int64) - got["iters"]) <= 2
    h = ref["hit"]
    nan_eq = (np.isnan(ref["normal"]) == np.isnan(got["normal"])).all(-1)
    n_close = (np.abs(np.nan_to_num(ref["normal"])
                      - np.nan_to_num(got["normal"])) <= 1e-5).all(-1)
    v_close = ((np.abs(ref["voxel_pos"] - got["voxel_pos"]) <= 1e-4)
               | (np.isnan(ref["voxel_pos"]) & np.isnan(got["voxel_pos"]))
               ).all(-1)
    hit_ok = ((ref["value"] == got["value"]) & (ref["node"] == got["node"])
              & (np.abs(ref["t"] - got["t"]) <= 1e-4)
              & (ref["scale_exp2"] == got["scale_exp2"])
              & (ref["depth"] == got["depth"]) & nan_eq & n_close & v_close)
    ok &= ~h | hit_ok
    return bool(hit_eq.all()), float((ok & hit_eq).mean())


def _run(jt, tree, o, d, oracle_rays=ORACLE_RAYS, active=None, **kw):
    ref = _np(jtraverse.intersect_octree(
        jt.to_device().arrays(), jnp.asarray(o), jnp.asarray(d),
        active=None if active is None else jnp.asarray(active), **kw))
    got = _np(traverse.intersect_octree(
        tree, torch.from_numpy(o), torch.from_numpy(d),
        active=None if active is None else torch.from_numpy(active), **kw))
    hit_eq, strict = _agreement(ref, got)
    print(f"vs JAX: {o.shape[0]} rays, hits {got['hit'].mean():.3f}, hit "
          f"mask equal {hit_eq}, strict {strict:.4f}")
    assert hit_eq and strict >= MIN_STRICT
    if oracle_rays:
        m = min(oracle_rays, o.shape[0])
        orc = _oracle(jt, o[:m], d[:m], max_depth=kw.get("max_depth", 13),
                      cone_trace=kw.get("cone_trace", False))
        sub = {k: v[:m] for k, v in got.items()}
        hit_eq, strict = _agreement(orc, sub)
        print(f"vs traverse_ref: {m} rays, hit mask equal {hit_eq}, strict "
              f"{strict:.4f}")
        assert hit_eq and strict >= MIN_STRICT
    return got


@pytest.mark.parametrize("name,seed", [("sphere-64", 3), ("terrain-64", 4)])
def test_random_rays(scenes, name, seed):
    jt, tree = scenes[name]
    o, d = random_rays(2048, seed=seed)
    got = _run(jt, tree, o, d)
    assert 0.2 < got["hit"].mean() < 0.95


@pytest.mark.parametrize("kw", [dict(max_depth=3), dict(cone_trace=True),
                                dict(max_depth=8, cone_trace=True)])
def test_depth_cutoff_and_cone(scenes, kw):
    jt, tree = scenes["terrain-64"]
    o, d = random_rays(1024, seed=5)
    got = _run(jt, tree, o, d, **kw)
    assert got["depth"][got["hit"]].max() <= kw.get("max_depth", 13)


def test_checkerboard_stress(scenes):
    jt, tree = scenes["checker-16"]
    o, d = random_rays(512, seed=7)
    _run(jt, tree, o, d)


def test_axis_aligned_rays(scenes):
    """Axis-aligned rays exercise the EPS direction clamps."""
    jt, tree = scenes["sphere-64"]
    grid = np.linspace(1.05, 1.95, 6)
    o, d = [], []
    for a in grid:
        for b in grid:
            for ax in range(3):
                for sgn in (1.0, -1.0):
                    p = [0.5 if sgn > 0 else 2.5] * 3
                    p[(ax + 1) % 3], p[(ax + 2) % 3] = a, b
                    v = [0.0, 0.0, 0.0]
                    v[ax] = sgn
                    o.append(p)
                    d.append(v)
    _run(jt, tree, np.array(o, np.float32), np.array(d, np.float32))


def test_active_mask_and_nan_rays(scenes):
    jt, tree = scenes["terrain-64"]
    o, d = random_rays(1024, seed=9)
    o[::37] = np.nan
    d[5::41, 1] = np.inf
    active = np.random.default_rng(2).uniform(size=1024) < 0.8
    got = _run(jt, tree, o, d, oracle_rays=0, active=active)
    dead = ~active | ~np.isfinite(o).all(1) | ~np.isfinite(d).all(1)
    assert not got["hit"][dead].any() and (got["iters"][dead] == 0).all()
    assert (got["node"][dead] == -1).all() and got["hit"][~dead].any()


def test_iteration_cap_and_limits(scenes):
    """Rays still active at max_iterations are misses, counted to the cap;
    max_depth beyond the stack window raises."""
    jt, tree = scenes["checker-16"]
    o, d = random_rays(256, seed=8)
    packed = traverse.make_packed_table(tree)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    prof = {}
    capped = traverse.intersect_octree(tree, ot, dt, max_iterations=6,
                                       packed=packed, profile=prof)
    full = traverse.intersect_octree(tree, ot, dt, packed=packed)
    at_cap = (capped.iters == 6) & ~capped.hit
    assert at_cap.any() and prof["capped"] == int(at_cap.sum())
    assert prof["rays"] == 256 and prof["launches"] == 0
    assert torch.equal(capped.hit, full.hit & (full.iters <= 6))
    with pytest.raises(ValueError):
        traverse.intersect_octree(tree, ot, dt, max_depth=14)
    with pytest.raises(ValueError):
        traverse.intersect_octree(tree, ot.double().float()[:, :2], dt)
