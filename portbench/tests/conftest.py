"""CPU tests of the benchmark: the tiny configurations under tiny/ (a 64^3
world of the bench world's generator in 32^3 chunks, 64x40 frames, the
system's plain versions on the CPU) rehearse every kind of traffic's loop,
the traced run and the reference.  They are not cells.

A tiny rehearsal root is any directory under tiny/, tiny/ itself
included, that holds a ``BENCHMARK.json`` with its ``configs/`` and
``workloads/`` beside it.  A new kind of traffic brings its rehearsal as
new files, ``tiny/<kind>/BENCHMARK.json`` and the files it names; the
tests find its cells by name."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = Path(__file__).resolve().parent / "tiny"
SEED = 4_000_000_007
#: the sources a CPU run reads: it holds no device record, so neither a
#: device_trace metric nor a program_span one (the program's spans are
#: read from the device records they hold) has anything to read
CPU_SOURCES = {"host_clock"}


def tiny_roots():
    """Every tiny rehearsal root, sorted (tiny/ first)."""
    return sorted(p.parent for p in TINY.rglob("BENCHMARK.json"))


def tiny_cell_roots():
    """(cell name, root) of every tiny cell of every root; a name found in
    two roots appears twice (test_tiny refuses that)."""
    return [(w["name"], root) for root in tiny_roots()
            for w in json.loads((root / "BENCHMARK.json").read_text())
            ["workloads"]]


#: every tiny cell's name, in the roots' order
TINY_CELLS = list(dict.fromkeys(name for name, _ in tiny_cell_roots()))


def tiny_root(cell):
    """The one rehearsal root that holds tiny cell ``cell``."""
    roots = [root for name, root in tiny_cell_roots() if name == cell]
    if len(roots) != 1:
        raise LookupError(f"tiny cell {cell!r} is in {len(roots)} roots: "
                          f"{roots}")
    return roots[0]


def tiny_spec(cell):
    """(benchmark, workload entry, configuration, traffic, kind module) of
    tiny cell ``cell``, read from its root."""
    from portbench.harness import cell_spec
    root = tiny_root(cell)
    return cell_spec(root, cell, root / "workloads")


def tiny_cells_of(kind):
    """The tiny cells whose traffic is of kind ``kind``."""
    return [c for c in TINY_CELLS if tiny_spec(c)[3]["kind"] == kind]


def cpu_metrics(cell, which):
    """Names of the ``end_to_end`` or ``per_layer`` metrics that tiny cell
    ``cell`` reports on the CPU: those its root's BENCHMARK.json gives it
    with a source in :data:`CPU_SOURCES`."""
    from portbench.harness import metrics_of
    bench = tiny_spec(cell)[0]
    return {m["name"] for m in metrics_of(bench, cell, which)
            if m["source"] in CPU_SOURCES}


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_run(cell, trace=False, seed=SEED, seconds=0.0, device="cpu",
             **kw):
    """One run of tiny cell ``cell`` from its root (on the CPU unless
    ``device`` says otherwise)."""
    from portbench.harness import run
    root = tiny_root(cell)
    return run(cell, seed, seconds, trace, device=device, root=root,
               workloads=root / "workloads", log=lambda *a: None, **kw)
