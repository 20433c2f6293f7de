"""The port's spans (svo_raytracer_torch/utils/profiling.span) at the
layer boundaries of the frame path and the scene tables' build, under
torch.profiler on the CPU: which ``svo.*`` ranges a mode-0 frame (2
bounces) and a mode-2 frame open and how they nest, every top-level
operation of a frame inside one of its child spans, no
``record_function`` at all with no profiler recording, and the three
set-up timers."""

import bisect
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from svo_raytracer_torch import bench
from svo_raytracer_torch.core import build_np
from svo_raytracer_torch.ops import brick_scene, render_wave, wavefront
from svo_raytracer_torch.utils import profiling

W, H = 64, 40
CHILDREN = {"svo.assembly", "svo.prep", "svo.order", "svo.k1",
            "svo.decode", "svo.shade"}
# per frame on the CPU, where the plain trace takes no ray order
# (on the card each explicit segment opens svo.order too)
COUNTS = {
    0: {"svo.frame": 1, "svo.assembly": 2, "svo.prep": 3, "svo.k1": 3,
        "svo.decode": 3, "svo.shade": 3},
    2: {"svo.frame": 1, "svo.assembly": 2, "svo.prep": 2, "svo.k1": 2,
        "svo.decode": 2, "svo.shade": 2},
}


@pytest.fixture(scope="module")
def scene():
    tree = build_np.build_octree_np(chip_smoke.sphere_voxels(64, 20))
    ws = wavefront.prepare(brick_scene.brickify(tree), "cpu")
    cam5, _ = bench.place_camera(ws)
    return ws, cam5


def frame(scene, mode):
    ws, cam5 = scene
    return render_wave.render_frame_wavefront(
        ws, cam5, W, H, render_mode=mode, frame_number=3, gi_bounces=2)


def traced(fn, tmp_path):
    """The complete ('X') events of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def within(inner, outer):
    return (outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def svo_ranges(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("svo.")]


def parent(r, ranges):
    """The innermost svo range enclosing ``r`` (None at the top)."""
    outer = [o for o in ranges if o is not r and within(r, o)]
    return min(outer, key=lambda o: o["dur"])["name"] if outer else None


@pytest.mark.parametrize("mode", [0, 2])
def test_frame_spans_and_their_nesting(scene, mode, tmp_path):
    ranges = svo_ranges(traced(lambda: frame(scene, mode), tmp_path))
    got = {}
    for r in ranges:
        got[r["name"]] = got.get(r["name"], 0) + 1
    assert got == COUNTS[mode]
    for r in ranges:
        want = None if r["name"] == "svo.frame" else "svo.frame"
        assert parent(r, ranges) == want, r["name"]


@pytest.mark.parametrize("mode", [0, 2])
def test_every_top_level_op_of_a_frame_lies_in_a_child_span(scene, mode,
                                                           tmp_path):
    """An operation added to the frame path outside every span fails."""
    events = traced(lambda: frame(scene, mode), tmp_path)
    ranges = svo_ranges(events)
    top = [r for r in ranges if r["name"] == "svo.frame"][0]
    ops = sorted((e for e in events
                  if e.get("cat") == "cpu_op" and within(e, top)),
                 key=lambda e: (e["ts"], -e["dur"]))
    outer, end = [], float("-inf")
    for o in ops:                  # ops that no other op encloses
        if o["ts"] >= end:
            outer.append(o)
            end = o["ts"] + o["dur"]
    assert len(outer) > 50
    children = sorted((r for r in ranges if r["name"] in CHILDREN),
                      key=lambda r: r["ts"])
    starts = [c["ts"] for c in children]
    loose = []
    for o in outer:                # the child span that starts last before
        i = bisect.bisect_right(starts, o["ts"]) - 1
        if i < 0 or not within(o, children[i]):
            loose.append(o["name"])
    assert loose == []


def test_the_ray_order_opens_its_span(scene, tmp_path):
    ws, _ = scene
    o = torch.tensor([[10.0, 60.0, 10.0], [30.0, 50.0, 20.0]])
    d = wavefront.unit_rows(torch.tensor([[0.1, -1.0, 0.2],
                                          [-0.3, -1.0, 0.1]]))
    alive = torch.ones(2, dtype=torch.bool)
    events = traced(lambda: wavefront.ray_order(ws, o, d, alive), tmp_path)
    ranges = svo_ranges(events)
    assert [r["name"] for r in ranges] == ["svo.order"]
    sorts = [e for e in events if e["name"] == "aten::sort"]
    assert sorts and all(within(s, ranges[0]) for s in sorts)


def test_no_record_function_without_a_profiler(scene, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for mode in (0, 2):
        col, _, _ = frame(scene, mode)
        assert bool(torch.isfinite(col).all())
    assert profiling.span("svo.frame") is profiling.span("svo.k1")


def test_the_set_up_timers_record_seconds():
    profiling.reset()
    tree = build_np.build_octree_np(chip_smoke.sphere_voxels(64, 20))
    host = tree.to_device("cpu").to_numpy()
    wavefront.prepare(brick_scene.brickify(host), "cpu")
    got = profiling.summary()
    for name in ("svo.to_numpy", "svo.brickify", "svo.prepare"):
        assert got[name]["count"] == 1 and got[name]["last_ms"] > 0, name
    profiling.reset()
