"""Device work by the program's own spans: each device record of a
``trace.Trace`` is given to the innermost ``svo.*`` range of the host
thread that launched it.

The program marks its layer boundaries with ``svo_raytracer_torch.utils.
profiling.span``, a ``record_function`` range under the profiler, which
lands in the chrome trace as a ``user_annotation`` event on the host's
clock.  A device record (kernel, memcpy or memset) names its host launch
by ``args.correlation``; the launch's start on its thread falls inside
the ranges open at that moment, and the innermost one (the latest to
start) takes the record.  The profiler's own step ranges and the device
side's ``gpu_user_annotation`` copies of the ranges are never spans.
"""

from __future__ import annotations

import functools

PREFIX = "svo."


class Split:
    """Per span name, device ms and kernel records per unit and the share
    of all device records it holds; the shares of device records left
    without a span and without a host launch; the span names the trace
    holds."""

    def __init__(self, ms, kernels, shares, unattributed, unlaunched,
                 names):
        self.ms, self.kernels, self.shares = ms, kernels, shares
        self.unattributed, self.unlaunched = unattributed, unlaunched
        self.names = names


def _thread(e):
    return e.get("pid"), e.get("tid")


def _corr(e):
    return (e.get("args") or {}).get("correlation")


@functools.lru_cache(maxsize=2)
def split(trace) -> Split:
    """The :class:`Split` of ``trace`` (a ``portbench.trace.Trace``)."""
    ranges = {}
    for e in trace.host:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith(PREFIX):
            ranges.setdefault(_thread(e), []).append(e)
    names = {e["name"] for rs in ranges.values() for e in rs}
    launch_at = {}
    for e in trace.launches:
        if _corr(e) is not None:
            launch_at[_corr(e)] = (_thread(e), e["ts"])
    # the innermost range open at each launch: sweep each thread's ranges
    # (sorted by start) and launches in time order with a stack of the
    # ranges still open
    owner = {}
    by_thread = {}
    for corr, (thr, ts) in launch_at.items():
        by_thread.setdefault(thr, []).append((ts, corr))
    for thr, launches in by_thread.items():
        rs = sorted(ranges.get(thr, []), key=lambda e: (e["ts"], -e["dur"]))
        stack, i = [], 0
        for ts, corr in sorted(launches):
            while i < len(rs) and rs[i]["ts"] <= ts:
                stack.append(rs[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ts:
                stack.pop()
            # a range that ended under one still open (rounding at the
            # trace's microsecond grain) is skipped, not taken
            inner = next((r for r in reversed(stack)
                          if r["ts"] + r["dur"] > ts), None)
            if inner is not None:
                owner[corr] = inner["name"]
    ms, kernels, records = {}, {}, {}
    unattributed = unlaunched = 0
    for e in trace.device:
        corr = _corr(e)
        if corr not in launch_at:
            unlaunched += 1
            continue
        name = owner.get(corr)
        if name is None:
            unattributed += 1
            continue
        ms[name] = ms.get(name, 0.0) + e["dur"] * 1e-3 / trace.units
        records[name] = records.get(name, 0) + 1
        if e["cat"] == "kernel":
            kernels[name] = kernels.get(name, 0) + 1
    n = max(len(trace.device), 1)
    return Split(ms, {k: v / trace.units for k, v in kernels.items()},
                 {k: v / n for k, v in records.items()}, unattributed / n,
                 unlaunched / n, names)


def read(ctx, name, what):
    """Device ms (``what="ms"``) or kernel records (``"kernels"``) per
    unit under span ``name``; None where the trace holds no device record
    or no range of that name (a program without the span)."""
    if ctx.trace is None or ctx.trace.empty:
        return None
    s = split(ctx.trace)
    if name not in s.names:
        return None
    return (s.ms if what == "ms" else s.kernels).get(name, 0.0)


def timer_s(ctx, name):
    """Seconds of the program's last ``name`` timer
    (``svo_raytracer_torch.utils.profiling.summary()``) in a traced run;
    None without a device record or without that timer."""
    if ctx.trace is None or ctx.trace.empty:
        return None
    from svo_raytracer_torch.utils import profiling

    entry = profiling.summary().get(name)
    return None if entry is None else entry["last_ms"] * 1e-3
