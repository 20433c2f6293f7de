"""The trace arithmetic on a small synthetic chrome trace: busy as the
union of device intervals, classification by the metric files' name
patterns, the share of launches held, and the breakdown; the traced
window of a run leaves out the profiler's warm units."""

import pytest

from portbench.harness import Context, reader
from portbench.trace import Trace


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


K1 = "void (anonymous namespace)::wf_trace_kernel<false, false>(wf::Tables)"
KEY = "(anonymous namespace)::ray_key_kernel(float const*)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"

EVENTS = [
    # host: a range, a profiler step over all, an op, and the launches
    ev("user_annotation", "a host range", 0, 50),
    ev("user_annotation", "ProfilerStep#3", 0, 1000),
    ev("cpu_op", "aten::add", 60, 30),
    ev("cuda_runtime", "cudaLaunchKernel", 10, 2, 1),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 2, 2),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 2, 3),
    ev("cuda_runtime", "cudaLaunchKernel", 70, 2, 4),
    ev("cuda_runtime", "cudaMemsetAsync", 80, 2, 5),
    # device: K1 overlaps the key kernel; a gap 300..400 under aten::add
    ev("kernel", KEY, 100, 100, 1),
    ev("kernel", K1, 150, 150, 2),
    ev("kernel", SORT, 400, 100, 3),
    ev("kernel", ADD, 600, 200, 4),
    ev("gpu_memset", "Memset (Device)", 900, 100, 5),
]


def trace(units=2, window_s=2e-3):
    return Trace(EVENTS, units, window_s)


def test_busy_is_the_union_of_device_records():
    t = trace()
    # [100, 300) + [400, 500) + [600, 800) + [900, 1000) us
    assert t.busy_s == pytest.approx(600e-6)
    assert t.kernels_per_unit() == 2.0
    assert t.records_held == 1.0


def test_classification_by_the_metric_files():
    t = trace()
    ctx = Context(2, 2e-3, [], 0.0, {}, t, None, None, None)
    assert reader("k1_ms.frame")(ctx) == pytest.approx(0.075)
    assert reader("order_ms.frame")(ctx) == pytest.approx(0.1)
    assert reader("glue_ms.frame")(ctx) == pytest.approx(0.15)
    assert reader("launches.frame")(ctx) == 2.0


def test_breakdown():
    b = trace().breakdown()
    assert b["device_ops"][0] == [ADD, pytest.approx(200e-6)]
    assert len(b["device_ops"]) == 5
    gaps = b["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([100e-6, 100e-6, 100e-6])
    assert ["aten::add", pytest.approx(100e-6)] not in gaps
    assert all(name in ("idle", "aten::add") for name, _ in gaps)


def test_a_trace_without_device_records_reads_nothing():
    t = Trace([ev("cpu_op", "aten::add", 0, 10)], 1, 1e-3)
    ctx = Context(1, 1e-3, [], 0.0, {}, t, None, None, None)
    for name in ("k1_ms.frame", "order_ms.frame", "glue_ms.frame",
                 "launches.frame", "k1_roofline.frame"):
        assert reader(name)(ctx) is None


def test_the_traced_window_leaves_out_the_warm_units():
    """traced() runs warm + n units and keeps only the last n: the window
    spans their profiler steps, not the slow warm ones."""
    import time

    import torch

    from portbench.trace import traced

    def run(step):
        for i in range(5):
            time.sleep(0.2 if i < 2 else 0.01)
            torch.ones(8).add_(1)
            step()
        return "done"

    out, t = traced(run, 2, 3, lambda: None)
    assert out == "done" and t.units == 3
    assert 0.03 <= t.window_s < 0.2
    steps = [e for e in t.host if e["name"] == "aten::add_"]
    assert len(steps) == 3
