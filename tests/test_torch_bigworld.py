"""Port scene tables and hit decode for worlds above 1024^3 vs the JAX
package: the hand-built G = 64 (2048^3) scene of tests/test_wavefront.py
test_g64_world and the sparse paged 4096^3 scene (G = 128) of
tests/test_paged.py, both built by chip_smoke.py's jax-free helpers.

Tables must equal JAX ``prepare``'s word for word, ``slot_cell`` included,
with int32 and half-word (attr16) attributes and with the 2-D attribute
storage forced.  ``_finish`` must decode hand-made records as JAX
``_finish`` decodes the same records in its packed form: integer fields
exactly, float fields within 1e-6 (XLA may contract a*b + c into one
rounding on the CPU; voxels are 2.4e-4 apart in world units)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.ops import wavefront

SCENES = {"g64": chip_smoke.g64_scene,
          "paged-4096": chip_smoke.sparse_paged_scene}
# (attr16, attr2d) of prepare
STORAGE = {"int32": (False, None), "attr16": (True, None),
           "int32-2d": (False, True), "attr16-2d": (True, True)}


def _jax_scene(scene):
    return jbrick_scene.BrickScene(
        world_size=scene.world_size, grid_size=scene.grid_size,
        n_mixed=scene.n_mixed, l0_table=scene.l0_table,
        brick_slot=scene.brick_slot, brick_attr=scene.brick_attr,
        occ_words=scene.occ_words, attrs=scene.attrs)


@pytest.fixture(scope="module")
def scenes():
    """Per scene name: (port BrickScene, JAX BrickScene of the same arrays)."""
    return {name: (s, _jax_scene(s)) for name, s in
            ((n, make()) for n, make in SCENES.items())}


def _assert_wave_equal(ref, got):
    assert (ref.world_size, ref.grid_size, ref.n_mixed, ref.capacity,
            ref.attr16) == (got.world_size, got.grid_size, got.n_mixed,
                            got.capacity, got.attr16)
    for f in wavefront.WaveScene.ARRAYS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("name", list(SCENES))
def test_prepare_matches_jax(scenes, name, storage):
    scene, jscene = scenes[name]
    attr16, attr2d = STORAGE[storage]
    got = wavefront.prepare(scene, "cpu", attr16=attr16, attr2d=attr2d)
    _assert_wave_equal(jwavefront.prepare(jscene, attr16=attr16,
                                          attr2d=attr2d), got)
    assert got.attr_comb.dim() == (2 if attr2d else 1)
    assert got.pages == (2 if name == "paged-4096" else 0)


@pytest.mark.parametrize("storage", ["int32", "attr16-2d"])
@pytest.mark.parametrize("name", list(SCENES))
def test_from_reference_equals_prepare(scenes, name, storage):
    scene, jscene = scenes[name]
    attr16, attr2d = STORAGE[storage]
    jws = jwavefront.prepare(jscene, attr16=attr16, attr2d=attr2d)
    arrays = {f: np.asarray(getattr(jws, f))
              for f in wavefront.WaveScene.ARRAYS}
    meta = {k: getattr(jws, k) for k in ("world_size", "grid_size",
                                        "n_mixed", "capacity", "attr16")}
    got = wavefront.WaveScene.from_reference(arrays, meta, "cpu")
    _assert_wave_equal(jws, got)
    _assert_wave_equal(jws, wavefront.prepare(scene, "cpu", attr16=attr16,
                                              attr2d=attr2d))
    # an int32 table offered as attr16 (or the reverse) is refused
    with pytest.raises(ValueError):
        wavefront.WaveScene.from_reference(arrays, dict(meta,
                                                        attr16=not attr16),
                                           "cpu")


def test_encode_attr16_matches_jax():
    """tests/test_paged.py test_attr16_roundtrip's inputs."""
    rs = np.random.RandomState(0)
    v = rs.randint(0, 4, 4096)
    raw = rs.randint(0, 1000, 4096)
    depth = rs.randint(5, 13, 4096)
    a32 = (v | (raw << 8) | (depth << 24)).astype(np.int64)
    a32[0] = 0  # air
    got = wavefront._encode_attr16(a32, 12)
    want = jwavefront._encode_attr16(a32, 12)
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)
    assert np.array_equal(wavefront._encode_attr16(a32.astype(np.int32), 12),
                          want)


def _records(ws, n, seed):
    """Hand-made K1 records (status, t, cell, widx, iters) and world rays
    for which they are consistent.  Half the hits land 0.3-0.7 voxel
    inside the recorded voxel; the other half land on its entry face, as
    K1's hits do, 0.005 d short of it along the ray's major axis, where
    only the paged decode's 1e-2 nudge along d reaches the voxel (the
    float32 origin moves the point by < 5e-4 voxel).  A quarter each of
    mixed hits, uniform hits, misses and ITER_CAP retirements."""
    rs = np.random.RandomState(seed)
    G, wsz = ws.grid_size, ws.world_size
    slot = ws.brick_slot.numpy()
    attr = np.asarray(ws.attr_comb.numpy().reshape(-1)[
        ws.capacity * 32768:ws.capacity * 32768 + G ** 3])
    mixed = np.nonzero(slot >= 0)[0]
    uniform = np.nonzero((slot < 0) & (attr != 0))[0]
    kind = np.arange(n) % 4
    status = np.asarray([wavefront.MIXED, wavefront.UNIFORM, wavefront.MISS,
                         wavefront.CAPPED], np.int32)[kind]
    cell = np.where(kind == 0, mixed[rs.randint(0, len(mixed), n)],
                    uniform[rs.randint(0, len(uniform), n)])
    widx = rs.randint(0, 32768, n)
    brick = np.stack([cell // (G * G), (cell // G) % G, cell % G], 1)
    vox = brick * 32 + np.stack([widx // 1024, (widx // 32) % 32,
                                 widx % 32], 1)
    t = rs.uniform(5.0, 500.0, n).astype(np.float32)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    target = vox + rs.uniform(0.3, 0.7, (n, 3))
    k = np.abs(d).argmax(1)
    rows = np.nonzero(rs.rand(n) < 0.5)[0]
    dk = d[rows, k[rows]]
    target[rows, k[rows]] = (vox[rows, k[rows]] + (dk < 0)) - 0.005 * dk
    o = (1.0 + (target - t[:, None].astype(np.float64) * d) / wsz)
    hit = kind < 2
    rec = (status, np.where(kind == 2, 0.0, t).astype(np.float32),
           np.where(hit, cell, 0).astype(np.int32),
           np.where(hit, widx, 0).astype(np.int32),
           rs.randint(1, 4000, n).astype(np.int32))
    return rec, o.astype(np.float32), d


def _jax_pack(ws, rec):
    """The port's record in the JAX kernel's packed form: G <= 64 mixed
    slot << 15 | widx, paged mixed 1 << 29 | slot, uniform 1 << 30 | cell,
    misses and capped rays PACK_MISS."""
    status, _, cell, widx, _ = rec
    slot = ws.brick_slot.numpy()[cell]
    mixed = np.where(ws.pages > 0, (1 << 29) | slot, (slot << 15) | widx)
    pack = np.where(status == wavefront.MIXED, mixed,
                    np.where(status == wavefront.UNIFORM, (1 << 30) | cell,
                             jwavefront.PACK_MISS))
    return pack.astype(np.int32)


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("name", list(SCENES))
def test_finish_matches_jax(scenes, name, storage):
    scene, jscene = scenes[name]
    attr16, attr2d = STORAGE[storage]
    ws = wavefront.prepare(scene, "cpu", attr16=attr16, attr2d=attr2d)
    jws = jwavefront.prepare(jscene, attr16=attr16, attr2d=attr2d)
    rec, o, d = _records(wavefront.prepare(scene, "cpu"), 512, seed=7)
    got = wavefront._finish(ws, tuple(map(torch.from_numpy, rec)),
                            torch.from_numpy(o), torch.from_numpy(d))
    ref = jwavefront._finish(
        jnp.asarray(_jax_pack(ws, rec)), jnp.asarray(rec[1]),
        jnp.asarray(rec[4]), jws.brick_slot, jws.slot_cell, jws.attr_comb,
        jnp.asarray(o), jnp.asarray(d), ws.world_size, o.shape[0],
        ws.capacity)
    got = {k: v.numpy() for k, v in got._asdict().items()}
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    assert got["hit"].sum() == o.shape[0] // 2
    for k in ("hit", "value", "depth", "node", "iters", "t"):
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    for k in ("normal", "hit_pos", "voxel_pos", "scale_exp2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    # the voxel decides the attribute: air voxels of mixed bricks decode to
    # value 0 and solid ones to their material, so both occur
    vals = got["value"][got["hit"]]
    assert (vals == 0).any() and (vals != 0).any()
