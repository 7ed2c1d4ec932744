"""Fixtures of the benchmark's CPU tests: the cells shrunk to a tiny tree
and image, run through the harness on the CPU (the port's tiled path with
the plain versions of its kernels)."""
from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 977   # past 32 signed bits, as a run's seed may be


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(cell: str):
    """(workload entry, configuration, traffic) of a cell, as loaded by
    name."""
    b = bench()
    wl = {w["name"]: w for w in b["workloads"]}[cell]
    conf = {c["name"]: c for c in b["configs"]}[wl["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic" / f"{wl['traffic']}.json")
                    .read_text())
    return wl, cfg, tr


# BENCHMARK.json's cells, read once at collection: the tests that run a
# cell take them from here, so a cell that joins through its files alone
# gets its runs too
CELLS = [w["name"] for w in bench()["workloads"]]
# the first cell of each traffic kind, for the checks that one cell of a
# kind stands for all
FIRST = {}
for _cell in CELLS:
    FIRST.setdefault(cell_files(_cell)[2]["kind"], _cell)


SHRUNK_CAMERA = {"height": 64, "width": 256, "focal": 300.0}


def shrink(cfg: dict, tr: dict):
    """The cell at a size a CPU test holds: 2,000 roots (10,800 points), a
    64 x 256 image at focal 300 (the configuration's camera, and the
    traffic's where the traffic sets its own), a few frames or steps."""
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg["scene"]["n_roots"] = 2000
    cfg["camera"] = dict(SHRUNK_CAMERA)
    if "camera" in tr:
        tr["camera"] = dict(SHRUNK_CAMERA)
    if tr["kind"] == "flythrough":
        tr.update(poses=8, warmup_frames=2, trace_frames=2, check_frames=2)
    else:
        tr.update(views=4, warmup_steps=3, trace_steps=2)
    return cfg, tr


@pytest.fixture
def cpu_tiled(monkeypatch):
    """The port's tiled path on the CPU, whatever the tree's size."""
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")


@pytest.fixture
def run_cell(cpu_tiled, monkeypatch):
    """run_cell(cell, trace=0, seed=SEED, camera=None) -> (exit code,
    result line) of the shrunk cell on the CPU, through runner.execute;
    camera, where given, is set on the traffic as its own camera block.
    run_cell.res is what the traffic loop returned to the runner (its layer
    among it); run_cell.orbits and run_cell.gts the (height, width, focal)
    of every orbit and the (height, width) of every ground truth that
    `inputs` made in the test, control readings included."""
    import torch

    from benchmark.harness import inputs, runner

    def remembered(loop):
        def drive(ctx):
            run.res = loop(ctx)
            return run.res
        return drive

    for kind, loop in list(runner.LOOPS.items()):
        monkeypatch.setitem(runner.LOOPS, kind, remembered(loop))

    orbit, ground_truth = inputs.orbit, inputs.ground_truth

    def orbit_seen(seed, n, H, W, focal, *a, **kw):
        run.orbits.append((H, W, focal))
        return orbit(seed, n, H, W, focal, *a, **kw)

    def ground_truth_seen(seed, n_views, H, W, *a, **kw):
        run.gts.append((H, W))
        return ground_truth(seed, n_views, H, W, *a, **kw)

    monkeypatch.setattr(inputs, "orbit", orbit_seen)
    monkeypatch.setattr(inputs, "ground_truth", ground_truth_seen)

    def run(cell: str, trace: int = 0, seed: int = SEED, camera=None):
        wl, cfg, tr = cell_files(cell)
        cfg, tr = shrink(cfg, tr)
        if camera is not None:
            tr["camera"] = dict(camera)
        ctx = runner.Ctx(cell, cfg, tr, torch.device("cpu"), seed, 0.2,
                         bool(trace), time.time())
        return runner.execute(ctx, bench(), wl)

    run.orbits, run.gts = [], []
    return run
