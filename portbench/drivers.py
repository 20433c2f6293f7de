"""The traffic generator: a driver per kind of traffic reads its
parameters from the traffic file, builds the system under test from the
configuration, runs the closed loop of the window and hands what the
window produced to the reference.

A kind is a module of its own, ``kinds/<kind>.py``, found by the name in
the traffic file's ``kind``.  It holds ``Driver`` (a subclass of
:class:`Driver` below: ``warm``, ``run``, ``check``, ``control``),
``KEYS`` (the traffic keys it reads) and ``FAULTS`` (faults planted in
the system for the tests of ``correct``).  A configuration may state
only what the code builds: :data:`BUILDS` lists the values of the keys
that choose how the world and its tables are made, and :data:`CONFIG_KEYS`
every key a configuration file may hold.

Everything a driver takes from the system is the entry it drives and the
outputs it returns; cameras and the world's recipe are the benchmark's.
"""

from __future__ import annotations

import gc
import importlib.util
import time
from pathlib import Path

import numpy as np
import torch

from .reference import camera as ref_camera

KINDS = Path(__file__).resolve().parent / "kinds"
#: the world and tables the drivers build: perlin chunkgen terrain, 32^3
#: bricks, float32 throughout
BUILDS = {"generator": "perlin", "brick": 32, "precision": "float32"}
CONFIG_KEYS = {"name", "source", "source_parts", "assumed", "world_size",
               "chunk_size", "width", "height", "camera", *BUILDS}
#: traffic keys every kind reads
COMMON_KEYS = {"kind", "why", "warm_frames", "capture", "trace_units",
               "trace_warm_units", "tolerance", "limits"}


class Unsupported(ValueError):
    """A configuration or traffic file that asks for what the code does
    not build."""


def kind(name):
    """The module ``kinds/<name>.py``."""
    path = KINDS / f"{name}.py"
    if not path.is_file():
        raise Unsupported(f"no kind of traffic {name!r} (kinds/{name}.py)")
    spec = importlib.util.spec_from_file_location(
        "portbench.kinds." + name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_names():
    return sorted(p.stem for p in KINDS.glob("*.py"))


def validate(cfg, traffic):
    """Refuse a configuration or traffic file with a key the code does not
    read or a build it does not make; returns the traffic's kind module."""
    extra = set(cfg) - CONFIG_KEYS
    if extra:
        raise Unsupported(f"configuration keys not read: {sorted(extra)}")
    for key, value in BUILDS.items():
        if cfg.get(key) != value:
            raise Unsupported(f"configuration {key} {cfg.get(key)!r}: the "
                              f"benchmark builds {value!r}")
    mod = kind(traffic["kind"])
    extra = set(traffic) - COMMON_KEYS - mod.KEYS
    if extra:
        raise Unsupported(f"traffic keys not read by kind "
                          f"{traffic['kind']!r}: {sorted(extra)}")
    return mod


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    """Common set-up: the world on the device, then the traffic's tables."""

    def __init__(self, cfg, traffic, seed, dev, spans, log):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.spans, self.log = spans, log
        self.W, self.H = cfg["width"], cfg["height"]
        cam = cfg["camera"]
        self.pose = (cam["pos"], cam["pitch"], cam["yaw"])

    def span(self, name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(self.dev)
        self.spans[name] = time.perf_counter() - t0
        return out

    def build_world(self):
        from svo_raytracer_torch.models import procgen, world

        W, C = self.cfg["world_size"], self.cfg["chunk_size"]
        dev = self.dev
        self.tree = self.span("world_s", lambda: world.build_world(
            W, C, lambda o: procgen.generate_chunk(o, C, device=dev),
            world_offset=(0, -W // 2, 0)))

    def build_tables(self):
        from svo_raytracer_torch.ops import brick_scene, wavefront

        def tables():
            scene = brick_scene.brickify(self.tree.to_numpy(),
                                         self.cfg["brick"])
            return wavefront.prepare(scene, self.dev)

        self.ws = self.span("tables_s", tables)

    def cam5(self, pos, pitch, yaw):
        return torch.tensor(ref_camera.Camera(pos, pitch, yaw).uniform(),
                            dtype=torch.float32, device=self.dev)

    def capture_plan(self, among):
        """Indices of the window's units whose outputs are compared."""
        cap = self.traffic["capture"]
        k = min(cap["units"], among)
        return sorted(int(i) for i in self.rng.choice(among, k, replace=False))

    def loop(self, unit, seconds, plan, min_units, step=None):
        """Run ``unit(i, keep)`` closed-loop until ``seconds`` have passed,
        ``min_units`` units are done and every planned capture is taken,
        calling ``step()`` after each unit when given; returns (units,
        window seconds).  Each unit's host-clock latency goes to
        ``self.latencies``."""
        self.latencies = []
        i = 0
        t0 = time.perf_counter()
        last = max(plan) if plan else -1
        while True:
            a = time.perf_counter()
            unit(i, i in plan)
            self.latencies.append(time.perf_counter() - a)
            i += 1
            if step is not None:
                step()
            if (i > last and i >= min_units
                    and time.perf_counter() - t0 >= seconds):
                break
        return i, time.perf_counter() - t0

    def free(self):
        """Drop the system's state before the reference runs."""
        for name in ("tree", "ws", "viewer", "original_render"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
