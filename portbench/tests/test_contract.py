"""BENCHMARK.json against the benchmark's contract, and the files it
names: every configuration, traffic mix and metric reader is found by
name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in BENCH[kind]]
        assert len(ns) == len(set(ns)), kind
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
        assert "\t" not in e["why"]


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_must():
    from portbench.harness import metrics_of
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in metrics_of(BENCH, w["name"],
                                              "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        assert metrics_of(BENCH, w["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e = {x["name"] for x in metrics_of(BENCH, cell, "end_to_end")}
            assert m["moves"] in e, (m["name"], cell)


def test_files_found_by_name():
    from portbench.harness import HERE, cell_spec, reader
    for w in BENCH["workloads"]:
        _, _, cfg, traffic, kind = cell_spec(ROOT, w["name"])
        assert (HERE / "kinds" / f"{traffic['kind']}.py").is_file()
        assert callable(kind.Driver) and kind.FAULTS
        assert cfg["precision"] == "float32"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(reader(m["name"]))
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_additions_need_no_code_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    and entries are found by the harness as it stands, in a copy of the
    checkout."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "portbench/configs/terrain-1024-wave.json")
                     .read_text())
    cfg["name"] = "terrain-512-wave"
    cfg["world_size"] = 512
    (root / "portbench/configs/terrain-512-wave.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/workloads/gi3-still.json")
                         .read_text())
    traffic["gi_bounces"] = 1
    wl = tmp_path / "workloads"
    shutil.copytree(root / "portbench/workloads", wl)
    (wl / "gi1-still.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/hits_per_frame.frame.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    bench["configs"].append(dict(BENCH["configs"][0],
                                 name="terrain-512-wave",
                                 file="portbench/configs/terrain-512-wave"
                                      ".json"))
    cell = "terrain-512-wave.gi1-still"
    bench["workloads"].append(dict(BENCH["workloads"][0], name=cell,
                                   config="terrain-512-wave",
                                   traffic="gi1-still"))
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "hits_per_frame.frame",
                               "unit": "hits/frame", "better": "higher",
                               "source": "device_trace", "layer": "kernel K1",
                               "moves": "frame_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.rmtree(root / "portbench/workloads")
    shutil.copytree(wl, root / "portbench/workloads")
    probe = (
        "import json, sys\n"
        "from portbench import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "cell = sys.argv[1]\n"
        "_, w, cfg, tr, _ = harness.cell_spec('.', cell)\n"
        "pl = harness.metrics_of(b, cell, 'per_layer')\n"
        "print(json.dumps(dict(\n"
        "    size=cfg['world_size'], bounces=tr['gi_bounces'],\n"
        "    per_layer=[m['name'] for m in pl],\n"
        "    e2e=[m['name'] for m in harness.metrics_of(b, cell, 'end_to_end')],\n"
        "    value=harness.reader(pl[0]['name'])(None))))\n")
    out = subprocess.run([sys.executable, "-c", probe, cell], cwd=root,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    got = json.loads(out.stdout)
    assert got == {"size": 512, "bounces": 1,
                   "per_layer": ["hits_per_frame.frame"],
                   "e2e": ["frame_ms", "frame_p95_ms", "setup_s"],
                   "value": 7.0}


def test_unknown_cell_is_refused():
    from portbench.harness import Refused, cell_spec
    with pytest.raises(Refused):
        cell_spec(ROOT, "terrain-1024-wave.no-such-traffic")


def test_a_new_kind_is_found_by_its_file(tmp_path):
    """A kind of traffic added as kinds/<kind>.py is found by the name in
    a traffic file, with its keys and faults, without a code edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench/kinds/edits.py").write_text(
        "from portbench import drivers\n"
        "KEYS = {'brush'}\n"
        "class Driver(drivers.Driver):\n    pass\n"
        "FAULTS = {'stale': lambda patch: None}\n")
    probe = (
        "import json\n"
        "from portbench import drivers, faults\n"
        "cfg = json.load(open('portbench/configs/terrain-1024-wave.json'))\n"
        "k = drivers.validate(cfg, {'kind': 'edits', 'brush': 3})\n"
        "print(json.dumps([k.__name__, 'edits-stale' in faults.all_faults(),"
        " drivers.kind_names()]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    from portbench.drivers import kind_names
    assert "edits" not in kind_names()
    assert json.loads(out.stdout) == ["portbench.kinds.edits", True,
                                      sorted({*kind_names(), "edits"})]


def test_a_kind_and_its_tiny_cell_are_added_by_files_alone(tmp_path):
    """A kind of traffic (kinds/<kind>.py: here the frames driver on the
    same world with one planted fault) and its tiny rehearsal root
    (tests/tiny/<kind>/) added as new files to a copy of the checkout are
    rehearsed by the copy's own CPU tests, which pass: the new cell's sound
    run is correct and its fault comes out not correct."""
    import xml.etree.ElementTree as ET

    root = tmp_path / "checkout"
    skip = shutil.ignore_patterns("__pycache__", "_build")
    for name in ("portbench", "svo_raytracer_torch"):
        shutil.copytree(ROOT / name, root / name, ignore=skip)
    for name in ("BENCHMARK.json", "pytest.ini"):
        shutil.copy(ROOT / name, root / name)
    (root / "portbench/kinds/rehearsal.py").write_text(
        "from portbench import drivers\n"
        "frames = drivers.kind('frames')\n"
        "KEYS = frames.KEYS\n"
        "class Driver(frames.Driver):\n    pass\n"
        "FAULTS = {'stale': frames.FAULTS['stale']}\n")
    tiny = ROOT / "portbench/tests/tiny"
    new = root / "portbench/tests/tiny/rehearsal"
    (new / "configs").mkdir(parents=True)
    (new / "workloads").mkdir()
    cfg = json.loads((tiny / "configs/tiny-wave.json").read_text())
    (new / "configs/tiny-rehearsal.json").write_text(
        json.dumps(dict(cfg, name="tiny-rehearsal")))
    traffic = json.loads((tiny / "workloads/gi3-still.json").read_text())
    (new / "workloads/gi1-still.json").write_text(
        json.dumps(dict(traffic, kind="rehearsal", gi_bounces=1)))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    cell = "tiny-rehearsal.gi1-still"
    bench["configs"] = [dict(bench["configs"][0], name="tiny-rehearsal",
                             file="configs/tiny-rehearsal.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=cell,
                               config="tiny-rehearsal", traffic="gi1-still")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    (new / "BENCHMARK.json").write_text(json.dumps(bench))

    me = "portbench/tests/test_contract.py::" + \
        test_a_kind_and_its_tiny_cell_are_added_by_files_alone.__name__
    junit = tmp_path / "junit.xml"
    # the copy's tests run on their own: no worker or options of this run
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-m", "not gpu",
         "-q", "-p", "no:cacheprovider", "--deselect", me,
         f"--junitxml={junit}"], cwd=root, capture_output=True, text=True,
        env=dict(env, PYTHONPATH=str(root)))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = {case.get("name") for case in ET.parse(junit).iter("testcase")
              if len(case) == 0 or all(c.tag in ("system-out", "system-err")
                                       for c in case)}
    assert {"test_every_kind_has_a_tiny_cell[rehearsal]",
            f"test_sound_run[{cell}]", f"test_traced_run[{cell}]",
            f"test_precision_control_is_not_correct[{cell}]",
            "test_a_broken_timed_path_is_not_correct[rehearsal-stale]",
            "test_no_tiny_cell_is_in_two_roots",
            "test_every_tiny_traffic_names_a_kind"} <= passed, passed


@pytest.mark.parametrize("key,value", [
    ("generator", "heightmap"), ("brick", 64), ("precision", "bfloat16"),
    ("engine", "esvo")])
def test_a_configuration_the_code_does_not_build_is_refused(key, value):
    """A configuration that states another generator, brick size or
    precision, or a key the code does not read, is refused, not run as
    the perlin G = 32 float32 world under another name."""
    from portbench import drivers
    cfg = json.loads((ROOT / "portbench/configs/terrain-1024-wave.json")
                     .read_text())
    traffic = json.loads((ROOT / "portbench/workloads/gi3-still.json")
                         .read_text())
    drivers.validate(cfg, traffic)
    with pytest.raises(drivers.Unsupported):
        drivers.validate(dict(cfg, **{key: value}), traffic)


@pytest.mark.parametrize("traffic_name,extra", [
    ("gi3-still", {"engine": "esvo"}), ("direct-fly", {"engine": "esvo"}),
    ("gi3-still", {"kind": "no-such-kind"})])
def test_traffic_the_code_does_not_read_is_refused(traffic_name, extra):
    from portbench import drivers
    cfg = json.loads((ROOT / "portbench/configs/terrain-1024-wave.json")
                     .read_text())
    traffic = json.loads((ROOT / f"portbench/workloads/{traffic_name}.json")
                         .read_text())
    with pytest.raises(drivers.Unsupported):
        drivers.validate(cfg, dict(traffic, **extra))
