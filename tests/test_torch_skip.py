"""The port's coarse DDA (kernel K2's plain version, brick_dda.
coarse_dda_plain) and skip grid against the JAX package's: the Pallas K2
in interpret mode, the scalar DDA oracle of tests/test_brick_dda.py, the
host skip-grid build word for word, and the skip contract of
tests/test_skip_grid.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.core import build_np
from svo_raytracer_tpu.ops import brick_dda as jbrick_dda
from svo_raytracer_tpu.ops import skip_grid as jskip_grid
from svo_raytracer_torch.core import octree
from svo_raytracer_torch.ops import brick_dda, brick_scene, skip_grid
from svo_raytracer_torch.ops import traverse
from test_brick_dda import dda_oracle

#: XLA contracts multiply-adds in the JAX kernel's t arithmetic that the
#: port rounds twice (measured on these rays: hit, cell and steps equal on
#: every ray, t bit-equal on 99.2-99.6% and within T_TOL on all)
MIN_AGREE = 0.995
T_TOL = 1e-5


def _table(vox):
    return torch.from_numpy(brick_scene.table_rows(
        brick_scene.pack_occupancy(vox)))


def _rays(G, B, seed):
    rng = np.random.default_rng(seed)
    o = np.where(rng.random((B, 1)) < 0.5, rng.uniform(0, G, (B, 3)),
                 rng.uniform(-G, 2 * G, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1] = 3e-5              # inside the 1e-4 clamp window
    o[::53] = np.nan              # non-finite rays
    return o, d, rng.uniform(size=B) < 0.9


@pytest.mark.parametrize("G", [8, 16, 32])
def test_coarse_dda_matches_jax_kernel(G):
    rng = np.random.default_rng(G)
    vox = rng.random((G, G, G)) < 0.03
    o, d, act = _rays(G, 1024, seed=G + 1)
    ref = jbrick_dda.coarse_dda(
        jbrick_dda.table_rows(jbrick_dda.pack_occupancy(vox)),
        jnp.asarray(o), jnp.asarray(d), grid_size=G,
        active=jnp.asarray(act), interpret=True)
    got = brick_dda.coarse_dda(_table(vox), torch.from_numpy(o),
                               torch.from_numpy(d), G,
                               active=torch.from_numpy(act))
    rt, gt = np.asarray(ref["t"]), got["t"].numpy()
    agree = {
        "hit": (np.asarray(ref["hit"]) == got["hit"].numpy()).mean(),
        "cell": (np.asarray(ref["cell"]) == got["cell"].numpy()).all(1)
        .mean(),
        "steps": (np.asarray(ref["steps"]) == got["steps"].numpy()).mean(),
        "t": ((np.abs(rt - gt) <= T_TOL * np.maximum(1.0, np.abs(rt)))
              | (np.isnan(rt) & np.isnan(gt))).mean()}
    print(f"G={G}: agreement {agree}, hits {got['hit'].float().mean():.3f}")
    assert min(agree.values()) >= MIN_AGREE, agree
    assert got["hit"].any() and not got["hit"].all()


@pytest.mark.parametrize("G", [16, 32])
def test_coarse_dda_matches_oracle(G):
    """tests/test_brick_dda.py::test_coarse_dda_matches_oracle's bar."""
    rng = np.random.default_rng(G)
    vox = rng.random((G, G, G)) < 0.03
    B = 256
    o = np.where(rng.random((B, 1)) < 0.5, rng.uniform(0, G, (B, 3)),
                 rng.uniform(-G, 2 * G, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = brick_dda.coarse_dda(_table(vox), torch.from_numpy(o),
                               torch.from_numpy(d), G)
    hit, t, cell = (out[k].numpy() for k in ("hit", "t", "cell"))
    n_checked = n_hits = 0
    for i in range(B):
        want_hit, want_t, want_cell = dda_oracle(
            vox, o[i].astype(np.float64), d[i].astype(np.float64), 3 * G)
        if want_hit != bool(hit[i]):
            continue
        n_checked += 1
        if want_hit:
            n_hits += 1
            assert (cell[i] == want_cell).all(), (i, cell[i], want_cell)
            assert abs(t[i] - want_t) < 1e-2 + 1e-3 * abs(want_t)
    print(f"G={G}: {n_checked}/{B} rays agree with the oracle, {n_hits} hits")
    assert n_checked >= B * 0.97 and n_hits > 5


def test_active_mask_and_miss():
    G = 16
    vox = np.zeros((G, G, G), bool)
    vox[8, 8, 8] = True
    o = torch.tensor([[8.5, 8.5, -5.0], [8.5, 8.5, -5.0], [0.5, 0.5, -5.0]])
    d = torch.tensor([[0, 0, 1.0]] * 3)
    out = brick_dda.coarse_dda(_table(vox), o, d, G,
                               active=torch.tensor([True, False, True]))
    assert out["hit"].tolist() == [True, False, False]
    assert out["cell"][0].tolist() == [8, 8, 8]
    assert abs(float(out["t"][0]) - 13.0) < 1e-2
    with pytest.raises(ValueError):
        brick_dda.coarse_dda(_table(vox), o, d, 128)


def test_near_axis_direction_clamped():
    G = 32
    rng = np.random.default_rng(99)
    vox = rng.random((G, G, G)) < 0.05
    B = 64
    o = rng.uniform(2, G - 2, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    ax = rng.integers(0, 3, B)
    mag = rng.uniform(1e-8, 9e-5, B).astype(np.float32)
    d[np.arange(B), ax] = np.where(d[np.arange(B), ax] >= 0, mag, -mag)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = brick_dda.coarse_dda(_table(vox), torch.from_numpy(o),
                               torch.from_numpy(d), G)
    hit, cell = out["hit"].numpy(), out["cell"].numpy()
    n_agree = 0
    for i in range(B):
        want_hit, _, want_cell = dda_oracle(
            vox, o[i].astype(np.float64), d[i].astype(np.float64), 3 * G)
        n_agree += want_hit == bool(hit[i]) and (
            not want_hit or (cell[i] == want_cell).all())
    assert n_agree >= B * 0.95, f"{n_agree}/{B}"


@pytest.fixture(scope="module")
def scene():
    """tests/test_skip_grid.py's scene: sine-blob solids plus a ball."""
    S = 64
    x, y, z = np.meshgrid(*(np.arange(S),) * 3, indexing="ij")
    vox = (np.sin(x * 0.31) + np.cos(y * 0.23) + np.sin(z * 0.17)) > 1.2
    vox |= np.sqrt((x - 40.0) ** 2 + (y - 20.0) ** 2 + (z - 40.0) ** 2) < 9
    jt = build_np.build_octree_np(vox.astype(np.uint8))
    tree = octree.from_reference(jt.child, jt.mask, jt.value, jt.normal,
                                 jt.n_nodes, jt.world_size).to_device("cpu")
    return vox, jt, tree


@pytest.mark.parametrize("G", [16, 32, 128])
def test_build_skip_grid_matches(scene, G):
    vox, jt, tree = scene
    ref = np.asarray(jskip_grid.build_skip_grid(jt, grid_size=G))
    got = skip_grid.build_skip_grid(tree, grid_size=G)
    assert got.dtype == np.int32 and np.array_equal(ref, got)
    assert np.array_equal(got, skip_grid.build_skip_grid(tree.to_numpy(),
                                                         grid_size=G))


def _skip_rays(B, seed=0):
    rng = np.random.default_rng(seed)
    o = np.full((B, 3), 1.5, np.float32)
    o += (rng.random((B, 3)).astype(np.float32) - 0.5) * 0.9
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def test_skip_preserves_hits(scene):
    """tests/test_skip_grid.py's contract: every hit class unchanged, t
    within 2e-3, the same values, fewer iterations."""
    vox, jt, tree = scene
    G = 16
    tab = torch.from_numpy(brick_scene.table_rows(
        skip_grid.build_skip_grid(tree, G)))
    o, d = _skip_rays(512)
    isect = functools.partial(traverse.intersect_octree, tree)
    base = isect(o, d)
    skipped = skip_grid.make_skipping_isect(isect, tab, grid_size=G)(o, d)
    bh = base.hit
    assert torch.equal(bh, skipped.hit)
    dt = (base.t[bh] - skipped.t[bh]).abs().max().item()
    print(f"skip: {int(bh.sum())} hits of 512, max |dt| {dt:.2e}, iters "
          f"{int(skipped.iters[bh].sum())} vs {int(base.iters[bh].sum())}")
    assert dt <= 2e-3
    assert torch.equal(base.value[bh], skipped.value[bh])
    assert skipped.iters[bh].sum() < base.iters[bh].sum()


def test_definite_misses_marked_inactive(scene):
    vox, jt, tree = scene
    G = 16
    tab = torch.from_numpy(brick_scene.table_rows(
        skip_grid.build_skip_grid(tree, G)))
    o = torch.tensor([[1.5, 2.5, 1.5]]).repeat(64, 1)
    d = torch.tensor([[0.0, 1.0, 0.0]]).repeat(64, 1)
    skip, maybe = skip_grid.skip_distances(tab, o, d, grid_size=G)
    assert not maybe.any() and (skip == 0).all()
