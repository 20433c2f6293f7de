"""Scoped timers and a device-trace scope (port of
svo_raytracer_tpu/utils/profiling.py).

The reference's observability is wall-clock prints around phases
(``Octree.java:195,272-290``), a per-frame time (``Window.java:83,102-103``)
and node-type counters (``Octree.java:31-34``); those live in
apps/app.Application.frame_time_ms and core/octree.Octree.node_counts.
This module adds named timers with summaries and a torch.profiler scope.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_timings: dict[str, list[float]] = defaultdict(list)


def _synchronize(out) -> None:
    """Wait for the devices of every tensor in ``out`` (a tensor, or a
    tuple, list or dict of them)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


@contextlib.contextmanager
def timer(name: str, sync=None):
    """Scoped wall-clock timer.  ``sync`` (tensors, or a callable that
    returns them) makes the scope end with torch.cuda.synchronize() on the
    devices they lie on, so the time includes their device work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            _synchronize(sync() if callable(sync) else sync)
        _timings[name].append(time.perf_counter() - t0)


def summary() -> dict[str, dict]:
    out = {}
    for name, ts in _timings.items():
        out[name] = {"count": len(ts), "total_s": sum(ts),
                     "mean_ms": 1000.0 * sum(ts) / len(ts),
                     "last_ms": 1000.0 * ts[-1]}
    return out


def reset() -> None:
    _timings.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler scope over the CPU and, where present, the card;
    writes a chrome trace into ``log_dir`` and yields the profiler (read
    ``key_averages()`` from it)."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
