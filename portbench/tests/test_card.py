"""On the card only (marked ``gpu``; skipped here): the tiny cells through
the kernels, correct, and the result's device fields.  The cells at their
own size run on the card through ``portbench/run.py`` and
``portbench/control.py``."""

import pytest

from conftest import SEED, TINY


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny-wave.gi3-still",
                                  "tiny-wave.direct-fly"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, cell, trace):
    from portbench.harness import run
    result, _ = run(cell, SEED, 0.5, trace, root=TINY,
                    workloads=TINY / "workloads", log=lambda *a: None)
    assert result["correct"] is True, result["checks"]
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
