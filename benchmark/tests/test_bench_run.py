"""A run of each cell on the CPU at a tiny size: the result line's keys,
the reference's agreement with the port's CPU path, and the exit without
a card."""
from __future__ import annotations

import io

import pytest

from conftest import bench

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["campus3m-view-1080p",
                                  "campus3m-train-1080p"])
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


def test_reference_agrees_with_port_cpu(run_cell):
    """The port's CPU path and the reference on the tiny tree: the cut
    equal, the 8-bit frame within a tenth of a level on average, the
    step's loss and norms within float32 rounding."""
    _, line = run_cell("campus3m-view-1080p")
    assert line["checks"]["cut_gap"][0] == 0.0
    assert line["checks"]["image_gap"][0] < 0.1
    _, line = run_cell("campus3m-train-1080p")
    assert line["checks"]["loss_gap"][0] < 1e-5
    assert line["checks"]["grad_gap"][0] < 1e-4
    assert line["checks"]["change_gap"][0] < 1e-3


@pytest.mark.parametrize("cell", ["campus3m-view-1080p",
                                  "campus3m-train-1080p"])
def test_traced_line(run_cell, cell):
    code, line = run_cell(cell, trace=1)
    assert code == 0
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    per = {m["name"] for m in bench()["per_layer"]}
    assert set(line["metrics"]) <= per


def test_no_card_no_result():
    """Without enough CUDA devices the run exits non-zero and prints no
    result."""
    import torch

    from benchmark.harness import runner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this is the no-card case")
    out = io.StringIO()
    code = runner.main(["--workload", "campus3m-view-1080p", "--seed", "1",
                        "--seconds", "1"], out=out)
    assert code != 0 and out.getvalue() == ""
