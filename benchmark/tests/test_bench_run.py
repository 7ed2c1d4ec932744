"""A run of each cell on the CPU at a tiny size: the result line's keys,
the reference's agreement with the port's CPU path, and the exit without
a card. The cells are BENCHMARK.json's (conftest.CELLS)."""
from __future__ import annotations

import io

import pytest

from conftest import CELLS, FIRST, bench, cell_files, shrink

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# a camera that a traffic file sets, unlike the shrunk configuration's
TRAFFIC_CAMERA = {"height": 48, "width": 192, "focal": 220.0}


def assert_camera(run_cell, cam):
    """Every orbit and ground truth of the run at cam, and a traced run's
    work counted over its pixels."""
    H, W = cam["height"], cam["width"]
    assert run_cell.orbits and set(run_cell.orbits) == {(H, W, cam["focal"])}
    lay = run_cell.res["layer"]
    assert set(run_cell.gts) == ({(H, W)} if lay["kind"] == "train"
                                 else set())
    assert all(w["pixels"] == H * W for w in lay["works"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(run_cell, cell):
    code, line = run_cell(cell)
    assert code == 0
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    e2e = {m["name"] for m in bench()["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == e2e
    assert line["attempted"] >= 1
    for value, limit in line["checks"].values():
        assert value <= limit
    # a traffic with no camera of its own renders at the configuration's
    # camera; shrunk, a traffic's own camera is the configuration's
    assert_camera(run_cell, shrink(*cell_files(cell)[1:])[0]["camera"])
    if run_cell.res["layer"]["kind"] == "train":
        # an untraced window keeps no step's counters
        assert run_cell.res["layer"]["step_stats"] == []


def test_reference_agrees_with_port_cpu(run_cell):
    """The port's CPU path and the reference on the tiny tree, in the
    first cell of each traffic kind: the cut equal, the 8-bit frame within
    a tenth of a level on average, the step's loss and norms within
    float32 rounding."""
    _, line = run_cell(FIRST["flythrough"])
    assert line["checks"]["cut_gap"][0] == 0.0
    assert line["checks"]["image_gap"][0] < 0.1
    _, line = run_cell(FIRST["train-cycle"])
    assert line["checks"]["loss_gap"][0] < 1e-5
    assert line["checks"]["grad_gap"][0] < 1e-4
    assert line["checks"]["change_gap"][0] < 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(run_cell, cell):
    """The traced line of every cell; the first cell of each traffic kind
    runs with a camera set on its traffic, which its orbit, ground truth
    and traced work follow in place of the configuration's."""
    first = cell in FIRST.values()
    code, line = run_cell(cell, trace=1,
                          camera=TRAFFIC_CAMERA if first else None)
    assert code == 0
    assert_camera(run_cell, TRAFFIC_CAMERA if first else
                  shrink(*cell_files(cell)[1:])[0]["camera"])
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    listed = {m["name"] for m in bench()["per_layer"]
              if cell in m["workloads"]}
    assert set(line["metrics"]) <= listed
    lay = run_cell.res["layer"]
    if lay["kind"] != "train":
        return
    # the program's own counters, one set a traced step, read by the
    # train-side metric files
    stats = lay["step_stats"]
    _, tr = shrink(*cell_files(cell)[1:])
    assert len(stats) == len(lay["steps"]) == tr["trace_steps"]
    assert all(isinstance(s["pair_total"], float) for s in stats)
    assert all(isinstance(s["counts"], list) for s in stats)
    if "pair_demand.train" in listed:
        mean = sum(s["pair_total"] for s in stats) / len(stats)
        assert line["metrics"]["pair_demand.train"]["value"] == mean > 0


def test_no_card_no_result():
    """Without enough CUDA devices the run exits non-zero and prints no
    result."""
    import torch

    from benchmark.harness import runner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this is the no-card case")
    out = io.StringIO()
    code = runner.main(["--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1"], out=out)
    assert code != 0 and out.getvalue() == ""
