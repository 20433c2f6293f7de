"""One run of one cell: find the cell, its configuration, its traffic and
its metrics by name, set up, measure the window (or trace it), check what
it produced against the reference, and return the result line.

Files are found by name, so a cell, a configuration, a traffic mix or a
metric is added by adding files and entries:

* ``BENCHMARK.json`` at the checkout's root: the cells, the
  configurations and the metrics;
* ``configs/<file>``: a configuration (named in BENCHMARK.json);
* ``workloads/<traffic>.json``: a traffic mix, read by the driver of its
  ``kind`` (``kinds/<kind>.py``);
* ``metrics/<name>.py``: the reader of a metric, ``read(ctx)`` giving
  its value, or None where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "svo_raytracer_tpu")


class Refused(Exception):
    """A run that must print no result (no card, a JAX import, ...)."""


def process_age() -> float:
    """Seconds since this process started (Linux /proc), for set-up."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(root, name, workloads=None):
    """(benchmark, workload entry, configuration, traffic, kind module) of
    cell ``name``; traffic files are read from ``workloads`` (default:
    this folder's ``workloads/``).  A configuration or traffic the code
    does not build is refused."""
    from . import drivers

    bench = load_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(Path(root) / cfg_entry["file"])
    traffic = load_json(Path(workloads or HERE / "workloads")
                        / f"{w['traffic']}.json")
    try:
        kind = drivers.validate(cfg, traffic)
    except drivers.Unsupported as e:
        raise Refused(f"cell {name}: {e}") from e
    return bench, w, cfg, traffic, kind


def metrics_of(bench, cell, which):
    """The ``end_to_end`` or ``per_layer`` metric entries reported by
    ``cell``: those whose ``workloads`` list it (an end-to-end metric
    without the key is every cell's)."""
    if which == "end_to_end":
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a metric reader reads: the window's units and latencies, the
    set-up's spans, the trace, the reference's walk counts."""

    def __init__(self, units, window_s, latencies, setup_s, spans, trace,
                 walks, pixels, frame_pixels):
        self.units, self.window_s = units, window_s
        self.latencies, self.setup_s, self.spans = latencies, setup_s, spans
        self.trace, self.walks = trace, walks
        self.pixels, self.frame_pixels = pixels, frame_pixels


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(cell, seed, seconds, trace, device="cuda", root=None, log=None,
        workloads=None, control=None):
    """Run cell ``cell`` once; returns (result dict, readings).
    ``device="cpu"`` skips the look for a card, and ``root`` and
    ``workloads`` point at another benchmark's files (tests);
    ``control(driver, reference)``, when given, returns the control's
    readings of the same window, kept under ``"control"`` (control.py)."""
    import torch

    from . import check, drivers, trace as tr

    root = Path(root or HERE.parent)
    log = log or (lambda *a: print("#", *a, file=sys.stderr, flush=True))
    bench, w, cfg, traffic, kind = cell_spec(root, cell, workloads)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available: the benchmark runs on the "
                          "card")
        if torch.cuda.device_count() < w["chips"]:
            raise Refused(f"cell {cell} needs {w['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
        torch.cuda.reset_peak_memory_stats()
    spans = {}
    drv = kind.Driver(cfg, traffic, seed, dev, spans, log)
    drv.build_world()
    drv.build_tables()
    drv.warm()
    setup_s = process_age()
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))
    trc = None
    if trace:
        warm, n = traffic["trace_warm_units"], traffic["trace_units"]
        (units, _), trc = tr.traced(
            lambda step: drv.run(0.0, warm + n, warm + n, step), warm, n,
            lambda: drivers.sync(dev))
        window_s = trc.window_s
        log(f"traced {n} units after {warm} warm ones in {window_s:.4f} s; "
            f"the trace holds device records of {trc.records_held:.4f} of "
            f"the host's kernel launches")
    else:
        units, window_s = drv.run(seconds, traffic["capture"]["among"])
        log("ms per unit, each second of the window: " + " ".join(
            f"{v:.3f}" for v in per_second(drv.latencies)))
    log(f"window: {units} units in {window_s:.4f} s")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    drv.free()
    walks = [] if trace else None
    t0 = time.perf_counter()
    ref = check.Reference(cfg, seed, dev, log, walks)
    readings = drv.check(ref)
    log(f"reference took {time.perf_counter() - t0:.3f} s")
    controls = control(drv, ref) if control is not None else None
    correct = check.verdict(readings)

    ctx = Context(units, window_s, drv.latencies, setup_s, spans, trc, walks,
                  traffic["capture"]["pixels"], cfg["width"] * cfg["height"])
    want = metrics_of(bench, cell, "per_layer" if trace else "end_to_end")
    metrics = {}
    for m in want:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded in the run's process: {bad}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trc is not None:
        device_info["busy_s"] = trc.busy_s
        device_info["window_s"] = trc.window_s
        result["breakdown"] = trc.breakdown()
    if controls is not None:
        result["control"] = {name: {"value": v, "limit": lim}
                             for name, v, lim in controls}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in readings}
    return result, readings


def per_second(latencies):
    """Mean latency (ms) of the units that ended in each second of the
    window."""
    out, acc, n, t = [], 0.0, 0, 0.0
    for x in latencies:
        acc, n, t = acc + x, n + 1, t + x
        if t >= len(out) + 1:
            out.append(acc / n * 1e3)
            acc, n = 0.0, 0
    if n:
        out.append(acc / n * 1e3)
    return out


def p95(latencies):
    """The 95th percentile of the latencies (s), by
    statistics.quantiles' exclusive method."""
    if len(latencies) < 2:
        return max(latencies)
    return statistics.quantiles(latencies, n=20)[18]
