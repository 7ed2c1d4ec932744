"""BENCHMARK.json holds to the benchmark's contract, and every cell,
configuration, traffic mix, limit and per-layer metric loads by name."""
from __future__ import annotations

import importlib.util
import json
import re

from conftest import ROOT, bench, cell_files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["benchmark"]
    assert b["command"][1] == "benchmark/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in b["end_to_end"] if m["name"] == "setup_s"]


def test_every_cell_loads_and_reports():
    """Whatever cells BENCHMARK.json lists: unique names, at most 24, one
    or four chips with at most a quarter (one at least) on four, each
    cell's configuration, traffic and limits files loading, a traffic
    kind that the runner drives, and the camera the cell renders at (the
    traffic's where it sets one) of positive whole height and width and a
    positive focal."""
    from benchmark.harness import inputs, runner

    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    assert 1 <= len(cells) <= 24 and len(cells) == len(set(cells))
    assert all(NAME.match(c) for c in cells)
    chips = [w["chips"] for w in b["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) \
        == len(cells)
    for cell in cells:
        wl, cfg, tr = cell_files(cell)
        assert tr["kind"] in runner.LOOPS
        assert cfg["name"] == wl["config"]
        cam = inputs.camera_of(cfg, tr)
        assert set(cam) == {"height", "width", "focal"}
        assert all(isinstance(cam[k], int) and cam[k] > 0
                   for k in ("height", "width"))
        assert cam["focal"] > 0
        e2e = {m["name"] for m in b["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in b["per_layer"] if cell in m["workloads"]]
        assert per and all(m["moves"] in e2e for m in per)
        limits = json.loads((ROOT / "benchmark" / "limits" /
                             f"{cell}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_every_metric_file_loads():
    for m in bench()["per_layer"]:
        path = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_configs_are_their_own_files():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        # the file's own list of changes names the same top-level keys
        assert sorted({k.split(".")[0] for k in cfg.get("reduced", [])}) \
            == sorted(c["reduced"])


def test_every_per_layer_metric_names_its_cells():
    """The harness reads a per-layer metric in the cells its `workloads`
    lists, and only there; each of them reports the metric it moves."""
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            e2e = [e["name"] for e in b["end_to_end"]
                   if "workloads" not in e or cell in e["workloads"]]
            assert m["moves"] in e2e
