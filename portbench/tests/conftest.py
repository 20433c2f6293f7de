"""CPU tests of the benchmark: the tiny configuration under tiny/ (a 64^3
world of the bench world's generator in 32^3 chunks, 64x40 frames, the
system's plain versions on the CPU) rehearses every cell's loop, the
traced run and the reference.  It is not a cell."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = Path(__file__).resolve().parent / "tiny"
SEED = 4_000_000_007


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_run(cell, trace=False, seed=SEED, **kw):
    from portbench.harness import run
    return run(cell, seed, 0.0, trace, device="cpu", root=TINY,
               workloads=TINY / "workloads", log=lambda *a: None, **kw)
