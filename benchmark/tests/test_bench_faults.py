"""The comparison fails what it must: each fault a cell can have, planted
in the port under a run on the CPU, and the control (the reference one
precision lower in the program's place) read against the sound port.
The faults run in the first cell of each traffic kind, the control in
every cell. Neither traffic loop spans chips, so no run can leave out an
exchange between them."""
from __future__ import annotations

import pytest
import torch

from conftest import CELLS, FIRST, SEED, cell_files, shrink


@pytest.fixture
def port():
    from log_tpu_torch.model import level_of_gaussian as lg
    from log_tpu_torch.model import train_step as ts

    return lg, ts


def _altered(lg, monkeypatch):
    """An answer altered where it is produced: the frame's top left
    corner brightened."""
    real = lg.LoG.render_fused

    def render_fused(self, camera, background):
        out = dict(real(self, camera, background))
        img = out["render"].clone()
        img[:, :16, :64] += 0.25
        out["render"] = img
        return out

    monkeypatch.setattr(lg.LoG, "render_fused", render_fused)


def _half_cut(ts, monkeypatch):
    """Half of the batch left out: every other row of the cut dropped."""
    real = ts.flat_cut_pre

    def flat_cut_pre(*args, **kw):
        keep = real(*args, **kw)
        return keep & (torch.arange(keep.shape[0]) % 2 == 0)

    monkeypatch.setattr(ts, "flat_cut_pre", flat_cut_pre)


def _stale_frame(lg, monkeypatch):
    """State left unchanged: every frame the first frame again."""
    real = lg.LoG.render_fused
    memo = {}

    def render_fused(self, camera, background):
        if "out" not in memo:
            memo["out"] = real(self, camera, background)
        else:
            real(self, camera, background)
        return memo["out"]

    monkeypatch.setattr(lg.LoG, "render_fused", render_fused)


def _unchanged_step(lg, monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(lg.LoG, "_apply_step",
                        lambda self, *a, **kw: None)


def _half_loss(ts, monkeypatch):
    """Half of the batch left out, the mean over the rest: the loss of the
    top half of the image."""
    real = ts._loss

    def loss(out, gt, *args, **kw):
        h = out["render"].shape[1] // 2
        half = dict(out, render=out["render"][:, :h])
        return real(half, gt[:, :h], *args, **kw)

    monkeypatch.setattr(ts, "_loss", loss)


VIEW_FAULTS = {"altered": _altered, "half_cut": _half_cut,
               "stale": _stale_frame}
TRAIN_FAULTS = {"unchanged": _unchanged_step, "half_loss": _half_loss}


@pytest.mark.parametrize("fault", sorted(VIEW_FAULTS))
def test_view_fault_fails(run_cell, port, monkeypatch, fault):
    lg, ts = port
    VIEW_FAULTS[fault](lg if fault != "half_cut" else ts, monkeypatch)
    code, line = run_cell(FIRST["flythrough"])
    assert code == 0 and line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_fault_fails(run_cell, port, monkeypatch, fault):
    lg, ts = port
    TRAIN_FAULTS[fault](lg if fault == "unchanged" else ts, monkeypatch)
    code, line = run_cell(FIRST["train-cycle"])
    assert code == 0 and line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates(run_cell, cell):
    """The control (the reference one precision lower in the program's
    place), and for the training cell the half-batch fault planted in the
    reference, come out not correct by the cell's own judgement and
    limits, while the sound port comes out correct, at the test's size."""
    from benchmark import control
    from benchmark.harness import check, inputs, runner

    _, sound = run_cell(cell)
    assert sound["correct"] is True
    _, cfg, tr = cell_files(cell)
    cfg, tr = shrink(cfg, tr)
    cfg["ref"] = runner.reference_config(cfg)
    dev = torch.device("cpu")
    if tr["kind"] == "flythrough":
        read = {"control": control.view_readings(cfg, tr, SEED, dev)}
    else:
        read = control.train_readings(cfg, tr, SEED, dev)
        assert set(read) == {"control", "half_batch"}
    limits = check.limits_for(cell)
    for name, numbers in read.items():
        correct, rows = check.judge(numbers, limits)
        assert correct is False, (name, rows, sound["checks"])
    # the control reads at the cell's camera, as the run does
    cam = inputs.camera_of(cfg, tr)
    assert set(run_cell.orbits) == {(cam["height"], cam["width"],
                                     cam["focal"])}
