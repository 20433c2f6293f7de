"""Device work by the program's spans on a small synthetic chrome trace:
each record goes to the innermost ``svo.*`` range open at its launch on
the launching thread; launches outside every such range, the profiler's
step ranges and the device side's annotation copies are never spans;
per-frame division; the eleven readers read nothing where the trace
holds no device record."""

import pytest

from portbench import spans
from portbench.harness import Context, reader
from portbench.trace import Trace

SPAN_METRICS = tuple(f"{k}_{w}.frame" for w in ("ms", "launches")
                     for k in ("assembly", "prep", "decode", "shade"))
TIMER_METRICS = ("to_numpy_s", "brickify_s", "prepare_s")


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, 1, corr, tid)


EVENTS = [
    ev("user_annotation", "ProfilerStep#5", 0, 1000),
    ev("user_annotation", "svo.frame", 5, 200),
    ev("user_annotation", "svo.assembly", 10, 20),
    ev("user_annotation", "svo.prep", 40, 20),
    ev("user_annotation", "svo.order", 60, 20),
    ev("user_annotation", "svo.k1", 80, 20),
    ev("user_annotation", "svo.shade", 120, 60),
    ev("user_annotation", "not a span", 125, 10),
    # the device side's copy of a range: never a span, never device work
    ev("gpu_user_annotation", "svo.shade", 500, 400, tid=9),
    launch(12, 1),                            # assembly
    launch(20, 2, name="cudaMemsetAsync"),    # assembly, a memset
    launch(45, 3),                            # prep
    launch(65, 4),                            # order, inside svo.frame
    launch(85, 5),                            # k1
    launch(110, 6),                           # svo.frame alone
    launch(126, 7),                           # shade, under "not a span"
    launch(300, 8),                           # outside svo.frame
    launch(90, 9, tid=2),                     # another thread: no span
    ev("kernel", "a", 100, 30, 1, tid=9),
    ev("gpu_memset", "Memset (Device)", 130, 10, 2, tid=9),
    ev("kernel", "b", 140, 40, 3, tid=9),
    ev("kernel", "c", 180, 20, 4, tid=9),
    ev("kernel", "K1", 200, 100, 5, tid=9),
    ev("kernel", "d", 300, 10, 6, tid=9),
    ev("kernel", "e", 310, 50, 7, tid=9),
    ev("kernel", "f", 400, 8, 8, tid=9),
    ev("kernel", "g", 410, 6, 9, tid=9),
    ev("kernel", "lost", 420, 4, 99, tid=9),  # no launch in the trace
]


def ctx_of(events, units=2):
    return Context(units, 1e-3, [], 0.0, {}, Trace(events, units, 1e-3),
                   None, None, None)


def test_each_record_goes_to_the_innermost_span():
    s = spans.split(Trace(EVENTS, 2, 1e-3))
    assert s.ms == pytest.approx({
        "svo.assembly": 0.02, "svo.prep": 0.02, "svo.order": 0.01,
        "svo.k1": 0.05, "svo.frame": 0.005, "svo.shade": 0.025})
    # the memset is device time but not a kernel record
    assert s.kernels == pytest.approx({
        "svo.assembly": 0.5, "svo.prep": 0.5, "svo.order": 0.5,
        "svo.k1": 0.5, "svo.frame": 0.5, "svo.shade": 0.5})
    assert s.shares["svo.assembly"] == pytest.approx(2 / 10)


def test_launches_outside_every_span_and_without_a_launch():
    s = spans.split(Trace(EVENTS, 2, 1e-3))
    # "f" launched after svo.frame, "g" on a thread with no range
    assert s.unattributed == pytest.approx(2 / 10)
    assert s.unlaunched == pytest.approx(1 / 10)


def test_steps_and_device_annotations_are_never_spans():
    s = spans.split(Trace(EVENTS, 2, 1e-3))
    assert all(n.startswith("svo.") for n in s.names)
    assert "ProfilerStep#5" not in s.ms and "not a span" not in s.ms
    # the gpu_user_annotation copy is not a device record
    assert sum(s.shares.values()) + s.unattributed + s.unlaunched == \
        pytest.approx(1.0)


@pytest.mark.parametrize("units", [1, 2, 4])
def test_the_readers_divide_by_the_units(units):
    ctx = ctx_of(EVENTS, units)
    assert reader("assembly_ms.frame")(ctx) == pytest.approx(0.04 / units)
    assert reader("assembly_launches.frame")(ctx) == pytest.approx(
        1 / units)
    assert reader("shade_ms.frame")(ctx) == pytest.approx(0.05 / units)
    assert reader("prep_launches.frame")(ctx) == pytest.approx(1 / units)
    # a span the trace does not hold reads nothing
    assert reader("decode_ms.frame")(ctx) is None


def test_a_span_without_device_work_reads_zero():
    events = EVENTS + [ev("user_annotation", "svo.decode", 190, 5)]
    ctx = ctx_of(events)
    assert reader("decode_ms.frame")(ctx) == 0.0
    assert reader("decode_launches.frame")(ctx) == 0.0


@pytest.mark.parametrize("name", SPAN_METRICS + TIMER_METRICS)
def test_a_trace_without_device_records_reads_nothing(name):
    ctx = ctx_of([ev("cpu_op", "aten::add", 0, 10),
                  ev("user_annotation", "svo.frame", 0, 10)], 1)
    assert reader(name)(ctx) is None
    no_trace = Context(1, 1e-3, [], 0.0, {}, None, None, None, None)
    assert reader(name)(no_trace) is None


def test_the_timer_readers_read_the_programs_last_timers():
    from svo_raytracer_torch.utils import profiling

    ctx = ctx_of(EVENTS)
    profiling.reset()
    assert all(reader(n)(ctx) is None for n in TIMER_METRICS)
    for name in ("svo.to_numpy", "svo.brickify", "svo.prepare"):
        with profiling.timer(name):
            pass
    got = [reader(n)(ctx) for n in TIMER_METRICS]
    assert all(isinstance(v, float) and v >= 0.0 for v in got)
    profiling.reset()
