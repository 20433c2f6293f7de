"""The port's bench (svo_raytracer_torch/bench.py) on the CPU: its small
pipeline (bench.py --small's 64^3 perlin world in one chunk) at a 64x40
frame, through the kernels' plain versions, against the JAX package.

Tolerance: exact.  The world's node table equals the JAX package's
build_world slot for slot; the probe camera equals bench.py's rule run on
the JAX package's intersect_wavefront (Pallas kernel in interpret mode,
as tests/test_torch_render.py runs it); every segment of the gi-1 and
gi-3 frames retires no ray at ITER_CAP (n_left 0), and each row carries
bench.py's fields.  The frame counts are cut to 1 warm and 1 timed frame:
the times of a CPU run measure nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_raytracer_tpu.models import procgen as jprocgen
from svo_raytracer_tpu.models import world as jworld
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_tpu.utils.camera import Camera as JCamera
from svo_raytracer_torch import bench
from test_torch_worldgen import _assert_tree_equal

S, CS = bench.SMALL[:2]
W, H = 64, 40


@pytest.fixture(scope="module")
def jax_world():
    """bench.py's build_scene without its cache, and its brick scene."""
    tree = jworld.build_world(
        S, CS, lambda o: jprocgen.generate_chunk(jnp.asarray(o, jnp.int32),
                                                 chunk_size=CS),
        world_offset=(0, -S // 2, 0)).to_numpy()
    return tree, jwavefront.prepare(jbrick_scene.brickify(tree))


def _jax_camera(jws):
    """bench.py:156-174 on the JAX package."""
    gx = np.linspace(1.2, 1.8, 5, dtype=np.float32)
    pxz = np.stack(np.meshgrid(gx, gx, indexing="ij"), -1).reshape(-1, 2)
    probe_o = np.concatenate([pxz[:, :1], np.full((25, 1), 1.999, np.float32),
                              pxz[:, 1:]], axis=1)
    probe_d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (25, 1))
    probe = jwavefront.intersect_wavefront(jws, jnp.asarray(probe_o),
                                           jnp.asarray(probe_d),
                                           interpret=True)
    ts = np.asarray(probe.t)
    best = int(np.argmax(ts))
    surf_y = 1.999 - float(ts[best])
    cam = JCamera(pos=np.array([probe_o[best, 0], min(surf_y + 0.05, 1.99),
                                probe_o[best, 2]]))
    cam.rotate(-0.35, 0.4)
    return np.asarray(cam.uniform(), np.float32), surf_y


def test_world_and_camera_equal_jax(jax_world):
    jtree, jws = jax_world
    tree, timings = bench.build_scene(S, CS, "cpu")
    _assert_tree_equal(tree, jtree)
    assert timings["build_s"] > 0 and "noise" in timings
    ws, prep = bench.build_brick_scene(tree, "cpu")
    assert ws.n_mixed == int(jws.n_mixed) and set(prep) == {
        "to_host", "brickify", "prepare"}
    cam5, surf_y = bench.place_camera(ws)
    jcam5, jsurf_y = _jax_camera(jws)
    assert surf_y == jsurf_y
    np.testing.assert_array_equal(cam5.numpy(), jcam5)


def test_small_pipeline_rows(monkeypatch):
    monkeypatch.setattr(bench, "WARM_FRAMES", 1)
    monkeypatch.setattr(bench, "TIMED_FRAMES", 1)
    rows = []
    last = bench.run(S, CS, W, H, "cpu", emit=rows.append)
    assert len(rows) == 2 and rows[1] == last
    gi1, gi3 = rows
    for row in rows:
        assert row["unit"] == "Mrays/s" and row["device"] == "cpu"
        assert row["value"] == pytest.approx(2 * W * H / row["frame_ms"]
                                             / 1e3)
        assert row["build_s"] > 0 and row["max_memory_allocated"] is None
    assert set(gi1) == {"metric", "value", "unit", "frame_ms", "n_left",
                        "build_s", "max_memory_allocated", "device"}
    assert set(gi3) == set(gi1) | {"frame_ms_gi3", "gi3_mrays"}
    assert gi1["n_left"] == {"prim": 0, "gi1": 0}
    assert gi3["n_left"] == {"prim": 0, "gi1": 0, "gi2": 0, "gi3": 0}
    assert gi3["gi3_mrays"] == pytest.approx(4 * W * H / gi3["frame_ms_gi3"]
                                             / 1e3)
    assert gi3["frame_ms"] == gi1["frame_ms"]


def test_frame_stats_segments():
    tree, _ = bench.build_scene(S, CS, "cpu")
    ws, _ = bench.build_brick_scene(tree, "cpu")
    cam5, _ = bench.place_camera(ws)
    stats, col = bench.frame_stats(ws, cam5, W, H, 3)
    assert len(stats) == 4 and stats[0]["camera"]
    assert stats[0]["rays"] == W * (-(-H // 32) * 32)   # block-major pad
    assert all(s["launches"] == 0 for s in stats)   # plain versions only
    assert col.shape == (H, W, 3) and bool(torch.isfinite(col).all())
    assert 0 < stats[0]["hits"] < stats[0]["rays"]


def test_bench_needs_the_card():
    """Asked for the card where there is none, the bench raises, with no
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(S, CS, W, H)
