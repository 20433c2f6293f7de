"""Reading a torch.profiler trace of the traced window: device records by
name, device busy as the union of kernel, memcpy and memset intervals,
the share of host launches whose device records the trace holds, and the
breakdown (longest device operations, longest idle gaps by what the host
was doing).

The profiler's chrome trace is the source: events of phase "X", device
records in DEVICE_CATS, host launches (cuda_runtime / cuda_driver events
named *Launch*, *Memcpy*, *Memset*) linked to their device records by
``args.correlation``, and host ranges (cpu_op, user_annotation).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")
BREAKDOWN_ENTRIES = 10
STEP = "ProfilerStep#"


class Trace:
    """The events of one traced window of ``units`` frames or steps that
    took ``window_s``."""

    def __init__(self, events, units, window_s):
        self.units = units
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.launches = [e for e in events
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and any(w in e.get("name", "") for w in LAUNCH_WORDS)]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]

    @property
    def empty(self) -> bool:
        """No device record at all (nothing ran on a card)."""
        return not self.device

    # -- device time
    @property
    def busy_s(self) -> float:
        """Seconds in which some device record ran (their union)."""
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy * 1e-6

    @property
    def records_held(self) -> float:
        """Share of the host's kernel launches whose device records the
        trace holds (records are lost late in some processes)."""
        launched = sum("LaunchKernel" in e["name"] for e in self.launches)
        return len(self.kernels) / max(launched, 1)

    def device_ms(self, match=None, records=None) -> float:
        """Device ms per unit of the records ``match(name)`` accepts (all
        records when ``match`` is None)."""
        recs = self.device if records is None else records
        return sum(e["dur"] for e in recs
                   if match is None or match(e["name"])) * 1e-3 / self.units

    def kernels_per_unit(self) -> float:
        return len(self.kernels) / self.units

    # -- breakdown
    def breakdown(self):
        """``device_ops``: the device operations that took most time (s,
        over the window); ``idle_gaps``: the longest intervals with no
        device record, each named by the innermost host range that
        covers most of it (the profiler's own step ranges, which cover
        every gap, left out)."""
        per = {}
        for e in self.device:
            per[e["name"]] = per.get(e["name"], 0.0) + e["dur"] * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = []
        end = None
        for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device):
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:BREAKDOWN_ENTRIES]:
            best, best_key = "idle", None
            for e in self.host:
                if e["name"].startswith(STEP):
                    continue
                lo, hi = max(a, e["ts"]), min(b, e["ts"] + e["dur"])
                if hi <= lo:
                    continue
                key = (hi - lo, -e["dur"])
                if best_key is None or key > best_key:
                    best, best_key = e["name"], key
            out.append([best, (b - a) * 1e-6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out}


def traced(run, warm, n, sync):
    """Trace ``n`` units under torch.profiler (host and device activity)
    after ``warm`` units traced and discarded, so the profiler's own
    start-up falls outside the window.  ``run(step)`` runs the ``warm + n``
    units, calling ``step()`` after each.  Returns (run's result, the Trace
    of the ``n`` units: its window spans their profiler steps, each unit
    ended by a synchronize).  The chrome trace goes to a temporary file
    in TMPDIR and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile, schedule

    box = {}

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                box["events"] = [e for e in json.load(f)["traceEvents"]
                                 if e.get("ph") == "X"]
        finally:
            os.remove(path)

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=n, repeat=1),
                 on_trace_ready=ready) as prof:
        out = run(prof.step)
    events = box["events"]
    steps = [e for e in events if e.get("name", "").startswith(STEP)]
    window = (max(e["ts"] + e["dur"] for e in steps)
              - min(e["ts"] for e in steps)) * 1e-6
    return out, Trace(events, n, window)
