"""Named spans and scoped timers (port of
svo_raytracer_tpu/utils/profiling.py).

The reference's observability is wall-clock prints around phases
(``Octree.java:195,272-290``), a per-frame time (``Window.java:83,102-103``)
and node-type counters (``Octree.java:31-34``); those live in
apps/app.Application.frame_time_ms and core/octree.Octree.node_counts.
This module adds:

* :func:`span`: a named range at a layer boundary.  Under a recording
  torch.profiler it is a ``record_function`` range, so it lands in the
  profiler's chrome trace as a ``user_annotation`` on the same clock as
  the device records; with no profiler recording it costs one flag check
  and keeps nothing.  The frame path's spans are named ``svo.<layer>``.
* :func:`timer`: a host-clock timer kept in memory (:func:`summary`),
  which also opens :func:`span` under its name.

No span synchronizes the device or reads a device value; a timer does
only when given ``sync``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_timings: dict[str, list[float]] = defaultdict(list)
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager marking ``name``'s range for a recording
    torch.profiler (``record_function``); a shared no-op context when no
    profiler records."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


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
    """Scoped wall-clock timer, inside :func:`span` ``name``.  ``sync``
    (tensors, or a callable that returns them) makes the scope end with
    torch.cuda.synchronize() on the devices they lie on, so the time
    includes their device work.  A scope that raises records nothing."""
    t0 = time.perf_counter()
    with span(name):
        yield
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
