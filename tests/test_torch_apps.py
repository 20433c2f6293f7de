"""The port's applications and runtime (svo_raytracer_torch/apps,
runtime/renderer.py) against the JAX package's, on the CPU.

  * the key map, the frame loop's hooks and the camera's moves equal
    JAX's (cam5 bit for bit, float64 moves);
  * DeviceTree's ranged update and its growth on overflow equal JAX's
    DeviceTree and a fresh padded upload, and its packed words a fresh
    traverse.make_packed_table;
  * scripted viewer sessions on the sphere demo world (64^3, 48x32):
    moves, modes 3 and 2, mode-0 accumulation over idle frames, a move
    that resets it, put_sphere, subtract_sphere, a screenshot, save and
    re-read.  Each ESVO frame of modes 2 and 3 equals JAX's render of the
    same cam5 and tree to the bar of tests/test_torch_esvo_render.py (hit
    mask equal, colour and depth within 1e-4 on >= 98% of pixels).  The
    wavefront tables of every world state (set-up, after each edit's
    brickify_patch + apply_patch, re-read) equal JAX's exactly, and the
    last mode-2 frame after both edits equals JAX's to the bar of
    tests/test_torch_render.py (hit mask equal, colour and depth within
    2e-3 on >= 97%).
    Mode-0 accumulation equals the JAX viewer's float32 host sum of the
    same frames exactly, the edits run no full brickify or prepare, the
    screenshot decodes to the frame's pixels and the saved world reads
    back;
  * worldgen writes JAX's .svo bytes (32^3 perlin world of 16^3 chunks,
    and a heightmap world from PNGs the test writes), and matgen JAX's
    pixels.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from svo_raytracer_tpu.apps import app as japp
from svo_raytracer_tpu.apps import input as jinput
from svo_raytracer_tpu.apps import matgen as jmatgen
from svo_raytracer_tpu.apps import viewer as jviewer
from svo_raytracer_tpu.apps import worldgen as jworldgen
from svo_raytracer_tpu.core import sdf as jsdf
from svo_raytracer_tpu.core import svo_format as jsvo_format
from svo_raytracer_tpu.core.octree import Octree as JOctree
from svo_raytracer_tpu.ops import brick_scene as jbrick_scene
from svo_raytracer_tpu.ops import render_wave as jrender_wave
from svo_raytracer_tpu.ops import shade as jshade
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_tpu.runtime import renderer as jrenderer
from svo_raytracer_tpu.utils.camera import Camera as JCamera
from svo_raytracer_torch.apps import app, input as input_mod, matgen
from svo_raytracer_torch.apps import viewer, worldgen
from svo_raytracer_torch.core import build_np, sdf, svo_format
from svo_raytracer_torch.io import image
from svo_raytracer_torch.ops import brick_scene, shade, traverse, wavefront
from svo_raytracer_torch.runtime.renderer import DeviceTree
from svo_raytracer_torch.utils.camera import Camera
from test_torch_patch import assert_wave_equal

W, H = 48, 32
# moves off the dyadic start (1.5, 1.5, 2.0) first: ESVO rays from a cube
# boundary take other step counts under XLA's multiply-add contraction
SCRIPT = ["q", "d", "w", "4", "3", "1", "", "", "w", "c", "x", "3", "p",
          "0", "9", "Q"]


def _jtree(t):
    return JOctree(child=t.child.copy(), mask=t.mask.copy(),
                   value=t.value.copy(), normal=t.normal.copy(),
                   n_nodes=t.n_nodes, world_size=t.world_size)


def test_keymap_equals_jax():
    assert input_mod.KEYBINDS == jinput.KEYBINDS
    for cmd in list(jinput.KEYBINDS) + ["", "zz", " w ", "\n", "Qx"]:
        assert input_mod.parse(cmd) == jinput.parse(cmd)


def test_frame_loop_equals_jax():
    def run(base):
        class Counting(base):
            calls = []

            def pre_run(self):
                self.calls.append("pre")

            def update_early(self):
                self.calls.append("early")
                if self.frame_count == 2:
                    self.running = False

            def update(self):
                self.calls.append("update")

            def update_late(self):
                self.calls.append("late")

            def post_run(self):
                self.calls.append("post")

        a = Counting()
        a.calls = []
        a.launch(max_frames=5)
        return a.calls, a.frame_count, a.running

    assert run(app.Application) == run(japp.Application)


def test_camera_equals_jax():
    a, b = Camera(pos=np.array([1.3, 1.6, 1.2])), JCamera(
        pos=np.array([1.3, 1.6, 1.2]))
    for dp, dy, fwd, side, up in ((0.1, 0.3, 1, 0, 0), (-0.7, 2.0, 0, 1, 2),
                                  (2.0, -9.0, -3, 2, -1)):
        for c in (a, b):
            c.rotate(dp, dy)
            c.strafe(fwd, side)
            c.move_vertical(up)
        for f in ("rotation", "forward", "right", "pos"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.uniform(), b.uniform())
        np.testing.assert_array_equal(a.ray_pick_location(0.37, 1024),
                                      b.ray_pick_location(0.37, 1024))


def _check_device_tree(dt, tree):
    fresh = tree.to_device("cpu", pad_to=dt.capacity)
    for x, y in zip(dt.arrays(), fresh.arrays()):
        assert torch.equal(x, y)
    assert torch.equal(dt.packed, traverse.make_packed_table(fresh))


@pytest.mark.parametrize("case", ["ranged", "grows"])
def test_device_tree_equals_jax(case):
    from conftest import make_sphere_voxels
    tree = build_np.build_octree_np(make_sphere_voxels(16, radius=5))
    jtree = _jtree(tree)
    cap = tree.n_nodes + (64 if case == "ranged" else 0)
    dt = DeviceTree(tree, "cpu", min_capacity=cap)
    jdt = jrenderer.DeviceTree(jtree, min_capacity=cap)
    ball = ((8, 8, 8), 2 if case == "ranged" else 6)
    new, cb = sdf.use_sdf_brush(tree, sdf.Sphere(*ball), 2, max_lod=4)
    jnew, _ = jsdf.use_sdf_brush(jtree, jsdf.Sphere(*ball), 2, max_lod=4)
    dt.ranged_update(new, cb)
    jdt.ranged_update(jnew, cb)
    assert dt.capacity == jdt.capacity >= new.n_nodes
    assert dt.n_nodes == jdt.n_nodes == new.n_nodes
    for x, y in zip(dt.arrays(), jdt.arrays()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    _check_device_tree(dt, new)
    assert dt.last_upload["full"] == (case == "grows")
    if case == "ranged":
        assert dt.last_upload["bytes"] == 16 * (cb.end0 - cb.start0
                                                + cb.end1 - cb.start1)


@pytest.mark.parametrize("case", ["ranged", "grows"])
def test_progressive_after_edit_reads_the_upload(case):
    """DeviceTree keeps the one packed cache of its DeviceOctree: a
    progressive frame rendered before an edit and again after it equals
    the frame of a fresh upload of the edited tree, bit for bit."""
    from conftest import make_sphere_voxels
    tree = build_np.build_octree_np(make_sphere_voxels(16, radius=5))
    cap = tree.n_nodes + (64 if case == "ranged" else 0)
    dt = DeviceTree(tree, "cpu", min_capacity=cap)
    cam = Camera(pos=np.array([1.5, 1.55, 1.05]))
    cam.rotate(0.0, 3.14159)   # facing the sphere and the edit
    cam5 = torch.from_numpy(cam.uniform().astype(np.float32))
    before, _ = shade.render_progressive(dt.dev, cam5, 16, 12, spp=2)
    ball = ((8, 8, 5), 2) if case == "ranged" else ((8, 8, 8), 6)
    new, cb = sdf.use_sdf_brush(tree, sdf.Sphere(*ball), 2, max_lod=4)
    dt.ranged_update(new, cb)
    assert dt.last_upload["full"] == (case == "grows")
    got, got_depth = shade.render_progressive(dt.dev, cam5, 16, 12, spp=2)
    ref, ref_depth = shade.render_progressive(
        new.to_device("cpu", pad_to=dt.capacity), cam5, 16, 12, spp=2)
    assert torch.equal(got, ref) and torch.equal(got_depth, ref_depth)
    assert not torch.equal(before, got)


def _session(engine, out_dir, monkeypatch):
    """Runs SCRIPT; returns (viewer, frames, loads, scenes): one dict per
    frame with its cam5 (float64), mode, frame number, raw colour and
    depth, accumulated colour and tree; the full brickify and prepare
    calls; a copy of the WaveScene of each world state (wavefront)."""
    tree = viewer._demo_tree("sphere", 64)
    v = viewer.Viewer(tree, W, H, out_dir, commands=list(SCRIPT),
                      engine=engine, device="cpu")
    frames, scenes, loads = [], [], {"brickify": 0, "prepare": 0}
    for mod, name in ((brick_scene, "brickify"), (wavefront, "prepare")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            loads[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    render, update, place = v.render, v.update_early, v._place_sdf

    def rec_render(cam5, *a):
        out = render(cam5, *a)
        if v.wave_scene is not None and not any(
                f["tree"] is v.tree_host for f in frames):
            # apply_patch writes in place: keep each state's tables
            scenes.append(dataclasses.replace(v.wave_scene, **{
                n: getattr(v.wave_scene, n).clone()
                for n in wavefront.WaveScene.ARRAYS}))
        frames.append(dict(cam=v.cam.uniform().copy(), cam5=cam5,
                           mode=v.render_mode, fn=v.frame_number,
                           color=out[0], depth=out[1], tree=v.tree_host,
                           accum_n=v._accum_n + (v.render_mode == 0)))
        return out

    def rec_update():
        update()
        frames[-1]["shown"] = v.color

    def checked_place(value):
        place(value)
        _check_device_tree(v.device_tree, v.tree_host)

    v.render, v.update_early, v._place_sdf = rec_render, rec_update, \
        checked_place
    v.launch(max_frames=len(SCRIPT))
    return v, frames, loads, scenes


def _jax_cameras(frames):
    """The JAX viewer's camera under the same commands equals the port's
    bit for bit at every frame."""
    jv = jviewer.Viewer(jviewer._demo_tree("sphere", 64), W, H)
    for cmd, f in zip(SCRIPT, frames):
        action = jinput.parse(cmd) if cmd else None
        if action in jviewer.Viewer._MOVING or (action or "").startswith(
                "render_mode_"):
            jv._apply(action)
        np.testing.assert_array_equal(jv.cam.uniform(), f["cam"])
        assert jv.render_mode == f["mode"]


def _check_accumulation(frames):
    """Mode 0: the JAX viewer's float32 host running mean of the same
    raw frames, bit for bit."""
    acc = None
    for f in frames:
        if f["mode"] != 0:
            acc = None
            continue
        c = f["color"].numpy()
        acc = c if f["accum_n"] == 1 else acc + c
        np.testing.assert_array_equal(f["shown"].numpy(),
                                      acc / f["accum_n"])
    assert max(f["accum_n"] for f in frames) == 3


def _close(ref_col, ref_depth, f, tol, min_close):
    ref_col, ref_depth = np.asarray(ref_col), np.asarray(ref_depth)
    col, depth = f["color"].numpy(), f["depth"].numpy()
    assert np.array_equal(ref_depth > 0, depth > 0)
    close = ((np.abs(ref_col - col).max(-1) <= tol)
             & (np.abs(ref_depth - depth) <= tol))
    assert close.mean() >= min_close, close.mean()
    return float((depth > 0).mean())


def _check_files(v, frames, out_dir):
    shot = [f for f in frames if f["fn"] == 2 and f["mode"] == 2][0]
    np.testing.assert_array_equal(image.read_png(v.last_screenshot),
                                  image.quantize(shot["shown"]))
    saved = [f["tree"] for f in frames][-3]
    back = svo_format.read_svo_file(os.path.join(out_dir, "level1.svo"),
                                    world_size=64)
    assert svo_format.export_svo(back) == svo_format.export_svo(saved)
    assert frames[-1]["tree"] is v.tree_host is not saved


def _edits_equal_jax(v, frames):
    """The session's edited trees equal JAX's brush at the same targets."""
    jt = _jtree(frames[0]["tree"])
    states = [jt]
    for e in v.edits:
        jt, _ = jsdf.use_sdf_brush(jt, jsdf.Sphere(e["target"], e["radius"]),
                                   e["value"])
        states.append(jt)
    trees = []
    for f in frames:
        if not any(f["tree"] is t for t in trees):
            trees.append(f["tree"])
    for t, jt in zip(trees, states):
        for x, y in zip(t.arrays(), jt.arrays()):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert len(v.edits) == 2 and v.edits[0]["n_nodes"] > v.edits[0][
        "n_nodes_before"]
    return trees


def test_viewer_esvo_session_equals_jax(tmp_path, monkeypatch):
    v, frames, loads, _ = _session("esvo", str(tmp_path), monkeypatch)
    assert loads == {"brickify": 0, "prepare": 0}
    _jax_cameras(frames)
    _check_accumulation(frames)
    _edits_equal_jax(v, frames)
    _check_files(v, frames, str(tmp_path))
    cap = v.device_tree.capacity
    hits = []
    for f in frames:
        if f["mode"] in (2, 3):
            jdev = _jtree(f["tree"]).to_device(pad_to=cap)
            ref = jshade.render_image(jdev.arrays(), jnp.asarray(
                f["cam5"].numpy()), W, H, render_mode=f["mode"],
                frame_number=f["fn"])
            hits.append(_close(ref[0], ref[1], f, 1e-4, 0.98))
    assert len(hits) == 10 and 0.1 < min(hits) and max(hits) < 0.95


def test_viewer_wavefront_session_equals_jax(tmp_path, monkeypatch):
    v, frames, loads, scenes = _session("wavefront", str(tmp_path),
                                        monkeypatch)
    # set-up and read_world rebuild; the two edits patch
    assert loads == {"brickify": 2, "prepare": 2}
    assert all(not e["scene_upload"]["full"] for e in v.edits)
    _jax_cameras(frames)
    _check_accumulation(frames)
    trees = _edits_equal_jax(v, frames)
    _check_files(v, frames, str(tmp_path))
    # JAX's scenes: set-up, each edit's patch, the re-read world's
    # rebuild; apply_patch donates its input, so each state is made after
    # the frames of the one before have rendered
    jscene = jbrick_scene.brickify(_jtree(trees[0]))
    jws, state = jwavefront.prepare(jscene), 0
    assert_wave_equal(jws, scenes[0])

    def advance(state, jws):
        if state < len(v.edits):
            e, t = v.edits[state], trees[state + 1]
            ball = jsdf.Sphere(e["target"], e["radius"])
            patch = jbrick_scene.brickify_patch(_jtree(t), jscene, ball.min,
                                                ball.max)
            return jwavefront.apply_patch(jws, jscene, patch)
        read = jsvo_format.read_svo_file(str(tmp_path / "level1.svo"),
                                         world_size=64)
        return jwavefront.prepare(jbrick_scene.brickify(read),
                                  capacity=jws.capacity)

    # an interpret-mode JAX frame of a new scene compiles for ~20 s: the
    # tables of every world state are compared, and the last mode-2 frame
    # after both edits
    last = max(i for i, f in enumerate(frames)
               if f["mode"] == 2 and f["tree"] is trees[2])
    for i, f in enumerate(frames):
        now = [j for j, t in enumerate(trees) if f["tree"] is t][0]
        while state < now:
            jws, state = advance(state, jws), state + 1
            assert_wave_equal(jws, scenes[state])
        if i == last:
            ref = jrender_wave.render_frame_wavefront(
                jws, jnp.asarray(f["cam5"].numpy()), W, H,
                render_mode=f["mode"], frame_number=f["fn"], interpret=True,
                use_static=False)
            assert 0.1 < _close(ref[0], ref[1], f, 2e-3, 0.97) < 0.95
    assert state == 3
    assert_wave_equal(jws, v.wave_scene)


def test_viewer_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.Viewer(viewer._demo_tree("sphere", 32), W, H)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.main(["--script", "Q"])


def test_worldgen_perlin_writes_jax_bytes(tmp_path):
    args = ["--size", "32", "--chunk", "16"]
    mine, ref = str(tmp_path / "port.svo"), str(tmp_path / "jax.svo")
    tree, times = worldgen.main(args + ["--cpu", "--out", mine])
    jworldgen.main(args + ["--cpu", "--out", ref, "--capacity", "65536"])
    data = open(mine, "rb").read()
    assert data == open(ref, "rb").read()
    assert times["bytes"] == len(data) and tree.n_nodes > 8 + 64
    assert set(times) >= {"noise", "build", "splice", "export"}


def _write_maps(d, gen):
    hm = (gen.uniform(0.1, 0.6, (40, 40)) * 65535).astype(np.uint16)
    hm[::3] //= 2
    mm = gen.integers(1, 4, (40, 40)).astype(np.uint8)
    Image.fromarray(hm).save(d / "hm.png")
    Image.fromarray(mm).save(d / "mm.png")


def test_worldgen_heightmap_writes_jax_bytes(tmp_path):
    _write_maps(tmp_path, np.random.default_rng(6))
    args = ["--kind", "heightmap", "--size", "32", "--chunk", "16",
            "--height-scale", "32", "--heightmap", str(tmp_path / "hm.png"),
            "--matmap", str(tmp_path / "mm.png")]
    mine, ref = str(tmp_path / "port.svo"), str(tmp_path / "jax.svo")
    tree, _ = worldgen.main(args + ["--cpu", "--out", mine])
    jworldgen.main(args + ["--cpu", "--out", ref, "--capacity", "65536"])
    assert open(mine, "rb").read() == open(ref, "rb").read()
    assert tree.node_counts()["surface_leaf"] > 0


def test_matgen_equals_jax(tmp_path):
    gen = np.random.default_rng(8)
    masks = tmp_path / "matmaps" / "nz"
    masks.mkdir(parents=True)
    for name, dt in (("stone", np.uint16), ("scree", np.uint8),
                     ("grass", np.uint16)):
        top = np.iinfo(dt).max
        m = np.where(gen.uniform(size=(24, 24)) < 0.4, top,
                     gen.integers(0, top, (24, 24))).astype(dt)
        Image.fromarray(m).save(masks / f"{name}.png")
    mine = matgen.bake(24, str(tmp_path), str(tmp_path / "port.png"))
    ref = jmatgen.bake(24, str(tmp_path), str(tmp_path / "jax.png"))
    for a, b in ((mine, ref), (mine.replace(".png", "_vis.png"),
                               ref.replace(".png", "_vis.png"))):
        want = np.asarray(Image.open(b))
        np.testing.assert_array_equal(np.asarray(Image.open(a)), want)
        np.testing.assert_array_equal(image.read_png(a), want)
    assert len(np.unique(np.asarray(Image.open(ref)))) == 4


def test_profiling_timers_and_trace(tmp_path):
    """utils/profiling: the JAX package's timer summary keys and a timer
    that synchronizes on its tensors' devices."""
    from svo_raytracer_tpu.utils import profiling as jprofiling
    from svo_raytracer_torch.utils import profiling
    profiling.reset()
    for _ in range(2):
        with profiling.timer("a", sync=lambda: torch.ones(3)):
            torch.ones(8).sum()
    jprofiling.reset()
    with jprofiling.timer("a"):
        pass
    got, want = profiling.summary()["a"], jprofiling.summary()["a"]
    assert set(got) == set(want) and got["count"] == 2
