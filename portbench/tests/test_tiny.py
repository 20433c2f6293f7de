"""Each cell's loop, traced run and reference at the tiny configuration
on the CPU: a sound run is correct and prints the contract's keys; a run
whose timed path is broken underneath is not correct, once for each fault
the cell can have (a state left unchanged, half the batch left out, an
answer altered where it is produced).  One chip: no exchange to leave
out."""

import pytest

from conftest import tiny_run
from portbench.faults import all_faults

FRAMES = "tiny-wave.gi3-still"
VIEWER = "tiny-wave.direct-fly"
FAULTS = all_faults()
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell,e2e", [
    (FRAMES, {"frame_ms", "frame_p95_ms", "setup_s"}),
    (VIEWER, {"frame_ms", "frame_p95_ms", "setup_s"})])
def test_sound_run(cell, e2e):
    result, readings = tiny_run(cell)
    assert list(result) == KEYS
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == e2e
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [r[0] for r in readings] == list(result["checks"])


@pytest.mark.parametrize("cell", [FRAMES, VIEWER])
def test_traced_run(cell):
    result, _ = tiny_run(cell, trace=True)
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and "breakdown" in result
    # on the CPU no device record exists: only the set-up spans read
    assert set(result["metrics"]) == {"world_s", "tables_s"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell = {"frames": FRAMES, "viewer": VIEWER}[fault.split("-")[0]]
    FAULTS[fault](monkeypatch.setattr)
    result, readings = tiny_run(cell)
    assert result["correct"] is False, readings


def test_precision_control_is_not_correct():
    """The control (the reference in bfloat16 in the system's place)
    fails a number of every cell."""
    from portbench.control import control
    for cell in (FRAMES, VIEWER):
        result, readings = tiny_run(cell, control=control)
        assert result["correct"] is True
        ctl = result["control"]
        assert any(not (v["value"] <= v["limit"]) for v in ctl.values()), \
            (cell, ctl)
