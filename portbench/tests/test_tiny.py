"""Each tiny cell's loop, traced run and reference on the CPU, for every
tiny cell found under tiny/: a sound run is correct and prints the
contract's keys; a run whose timed path is broken underneath is not
correct, once for each fault each kind of traffic can have (a state left
unchanged, half the batch left out, an answer altered where it is
produced), planted in a tiny cell of that kind.  One chip: no exchange to
leave out.  Every kind of traffic has a tiny cell."""

import json

import pytest

from conftest import (TINY_CELLS, cpu_metrics, tiny_cell_roots, tiny_roots,
                      tiny_cells_of, tiny_run)
from portbench.drivers import kind, kind_names
from portbench.faults import all_faults

FAULTS = all_faults()
#: the kind of traffic of each fault of all_faults()
FAULT_KINDS = {f"{k}-{name}": k for k in kind_names()
               for name in kind(k).FAULTS}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def rehearsal(kind_name):
    """The tiny cell that rehearses kind ``kind_name``."""
    cells = tiny_cells_of(kind_name)
    assert cells, (f"kind {kind_name!r} (kinds/{kind_name}.py) has no tiny "
                   f"cell: add tiny/{kind_name}/BENCHMARK.json and its files")
    return cells[0]


def test_no_tiny_cell_is_in_two_roots():
    names = [name for name, _ in tiny_cell_roots()]
    assert sorted(names) == sorted(set(names)), tiny_cell_roots()
    assert names


def test_every_tiny_traffic_names_a_kind():
    kinds = set(kind_names())
    for root in tiny_roots():
        files = sorted((root / "workloads").glob("*.json"))
        assert files, root
        for path in files:
            assert json.loads(path.read_text())["kind"] in kinds, path


@pytest.mark.parametrize("kind_name", kind_names())
def test_every_kind_has_a_tiny_cell(kind_name):
    rehearsal(kind_name)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_sound_run(cell):
    e2e = cpu_metrics(cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2, e2e
    result, readings = tiny_run(cell)
    assert list(result) == KEYS
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == e2e
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [r[0] for r in readings] == list(result["checks"])


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_traced_run(cell):
    result, _ = tiny_run(cell, trace=True)
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and "breakdown" in result
    # on the CPU no device record exists: only the host-clock spans read
    assert set(result["metrics"]) == cpu_metrics(cell, "per_layer")
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell = rehearsal(FAULT_KINDS[fault])
    FAULTS[fault](monkeypatch.setattr)
    result, readings = tiny_run(cell)
    assert result["correct"] is False, readings


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_precision_control_is_not_correct(cell):
    """The control (the reference in bfloat16 in the system's place)
    fails a number of every cell."""
    from portbench.control import control
    result, readings = tiny_run(cell, control=control)
    assert result["correct"] is True
    ctl = result["control"]
    assert any(not (v["value"] <= v["limit"]) for v in ctl.values()), \
        (cell, ctl)
