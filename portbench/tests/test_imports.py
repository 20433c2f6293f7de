"""Neither a run's process nor the reference loads JAX or the JAX
package, and the reference loads nothing of the system under test: each
module's top-level name is compared whole (``svo_raytracer_torch``
begins with ``svo_raytracer_t``, as the JAX package's name does)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

REFERENCE = ["portbench.reference.noise", "portbench.reference.world",
             "portbench.reference.walk", "portbench.reference.shade",
             "portbench.reference.camera", "portbench.roofline"]


def loaded_after(code):
    """Top-level names of the modules a fresh process holds after
    ``code``."""
    probe = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_none_of_them():
    code = ("import sys\n"
            "for m in ('jax', 'svo_raytracer_tpu', 'svo_raytracer_torch'):\n"
            "    sys.modules[m] = None\n")
    code += "".join(f"import {m}\n" for m in REFERENCE)
    code += ("for m in ('jax', 'svo_raytracer_tpu', 'svo_raytracer_torch'):\n"
             "    del sys.modules[m]\n")
    tops = loaded_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "svo_raytracer_tpu",
                       "svo_raytracer_torch"}


def test_a_run_loads_the_port_and_not_jax():
    code = (
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.harness import run\n"
        f"run('tiny-wave.direct-fly', 5, 0.0, False, device='cpu', "
        f"root={str(TINY)!r}, workloads={str(TINY / 'workloads')!r}, "
        f"log=lambda *a: None)\n")
    tops = loaded_after(code)
    assert "svo_raytracer_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "svo_raytracer_tpu"}


def test_a_run_holding_jax_prints_no_result(monkeypatch):
    import types

    from portbench.harness import Refused, forbidden_modules
    from conftest import tiny_run
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax"]
    with pytest.raises(Refused):
        tiny_run("tiny-wave.direct-fly")


def test_names_are_compared_whole(monkeypatch):
    import types

    from portbench.harness import forbidden_modules
    monkeypatch.setitem(sys.modules, "svo_raytracer_tpux",
                        types.ModuleType("svo_raytracer_tpux"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert forbidden_modules() == []


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "terrain-1024-wave.gi3-still", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
