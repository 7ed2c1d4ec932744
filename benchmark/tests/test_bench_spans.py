"""The readers of the program's spans (benchmark/harness/spans.py and the
seven metric files on it) on a synthetic trace whose device intervals and
nested spans are known: each idle metric's value, idle with no span of
the program falling to no layer, and the sync counts; and the training
step's launch and pair-demand readers on the same trace."""
from __future__ import annotations

import pytest

from benchmark.harness import runner, spans
from benchmark.harness.trace import Trace

# one frame (us): the spans and the device's busy intervals; idle falls to
# bench.vis 2, the entry (vis, vis.camera, the copies' waits, vis.to_numpy)
# 30, render_fused and its parts 11
FRAME = [("bench.vis", 0, 100), ("vis", 1, 99), ("vis.camera", 2, 5),
         ("render_fused", 5, 60), ("render_fused.inputs", 5, 15),
         ("sync.camera_device", 6, 8), ("sync.render_fused_buckets", 10, 14),
         ("render_fused.cull", 15, 30), ("render_fused.frame", 30, 60),
         ("vis.quantize", 60, 62), ("sync.vis_copy", 62, 80),
         ("vis.to_numpy", 80, 99)]
FRAME_BUSY = [(8, 12), (20, 70), (75, 78)]
# one step: idle to bench.training_step 2, the entry (trainer.*) 14,
# training_iteration.inputs 2, the visibility pass 4, the binning 5, the
# update 23, training_iteration.apply 3
STEP = [("bench.training_step", 0, 100), ("trainer.training_step", 1, 99),
        ("trainer.camera", 1, 3), ("trainer.gt", 3, 6),
        ("sync.gt_upload", 4, 5), ("training_iteration", 6, 90),
        ("training_iteration.inputs", 6, 10),
        ("train_step.visibility", 10, 30), ("sync.compact_fill", 12, 14),
        ("train_step.forward", 30, 50), ("raster.bin", 32, 40),
        ("train_step.update", 50, 85), ("train_step.counter", 50, 55),
        ("sync.counter_bincount", 51, 52), ("sync.counter_bincount", 52, 53),
        ("train_step.adam", 55, 80), ("sync.adam_lr", 56, 57),
        ("training_iteration.apply", 85, 90), ("trainer.output", 90, 95),
        ("sync.training_step_loss", 95, 97)]
STEP_BUSY = [(7, 9), (14, 35), (40, 52), (60, 70), (86, 88)]


def _layer(ranges, busy, copies, shift, top, between=()):
    """The run's Layer over `copies` frames or steps, each `shift` us after
    the last, with `between` spans (and idle) between them."""
    events = []
    for k in range(copies):
        o = 1000.0 + k * shift
        events += [{"ph": "X", "cat": "user_annotation", "name": n,
                    "ts": o + a, "dur": b - a} for n, a, b in ranges]
        events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": o + a,
                    "dur": b - a} for a, b in busy]
        if k:
            events += [{"ph": "X", "cat": "user_annotation", "name": n,
                        "ts": o - shift + a, "dur": b - a}
                       for n, a, b in between]
    tr = Trace(events)
    lay = runner.Layer(trace=tr, frames=[None] * copies,
                       steps=[0.1] * copies)
    lay.update(window=tr.window(top))
    return lay


def read(name, lay):
    return runner.load_metric(name).read(lay)


def test_view_idle_and_syncs():
    """Two frames 101 us apart, a sync.frame_stats span alone between
    them: its idle falls to no layer."""
    lay = _layer(FRAME, FRAME_BUSY, 2, 101, "bench.vis",
                 between=[("sync.frame_stats", 100, 101)])
    ms = 1e-3   # 1 us in ms
    assert read("entry_idle_ms.view", lay) == pytest.approx(30 * ms)
    assert read("model_idle_ms.view", lay) == pytest.approx(11 * ms)
    assert read("host_syncs_per_frame.view", lay) == 3
    owned = {}
    for n, s in spans.owned_idle(lay).items():
        owned[n.name] = owned.get(n.name, 0.0) + s
    assert "sync.frame_stats" not in owned
    assert owned["bench.vis"] == pytest.approx(2 * 2e-6)
    idle = sum(b - a for a, b in spans.idle_gaps(lay.trace, lay.window))
    assert idle == pytest.approx(2 * 43 + 1)
    assert sum(owned.values()) == pytest.approx((idle - 1) / 1e6)


def test_train_idle_and_syncs():
    """Two steps back to back: the trainer's, the visibility pass's and
    the update's idle, and the syncs in trainer.training_step."""
    lay = _layer(STEP, STEP_BUSY, 2, 100, "bench.training_step")
    ms = 1e-3
    assert read("entry_idle_ms.train", lay) == pytest.approx(14 * ms)
    assert read("cut_idle_ms.train", lay) == pytest.approx(4 * ms)
    assert read("optimizer_idle_ms.train", lay) == pytest.approx(23 * ms)
    assert read("host_syncs_per_step.train", lay) == 6


def test_train_step_counters():
    """launches_per_step.train: the window's kernels a step, None where it
    holds none; pair_demand.train: the mean of the steps' own pair_total,
    None where a step reports none."""
    top = "bench.training_step"
    lay = _layer(STEP, STEP_BUSY, 2, 100, top)
    assert read("launches_per_step.train", lay) == len(STEP_BUSY)
    assert read("launches_per_step.train",
                _layer(STEP, [], 2, 100, top)) is None
    for stats, want in [
            ([{"pair_total": 3.0e6}, {"pair_total": 2.0e6}], 2.5e6),
            ([{"pair_total": 3.0e6}, {"num_rendered": 5.0}], None),
            ([{"pair_total": -1.0}, {"pair_total": 2.0e6}], None),
            ([], None)]:
        lay.update(step_stats=stats)
        assert read("pair_demand.train", lay) == want, stats


@pytest.mark.parametrize("cell,ranges,busy,top,reads", [
    ("view", [("bench.vis", 0, 100), ("bench.render_fused", 5, 60)],
     FRAME_BUSY, "bench.vis", {}),
    ("train", [("bench.training_step", 0, 100),
               ("train_step.visibility", 10, 30),
               ("train_step.render", 30, 50), ("train_step.adam", 55, 80)],
     STEP_BUSY, "bench.training_step", {"cut_idle_ms.train": 4e-3}),
])
def test_without_the_programs_spans(cell, ranges, busy, top, reads):
    """A program that opens none of a metric's spans (the harness's bench.*
    alone, or the older train_step ranges) reads None there, and does not
    raise."""
    lay = _layer(ranges, busy, 2, 100, top)
    names = {"view": ["entry_idle_ms.view", "model_idle_ms.view",
                      "host_syncs_per_frame.view"],
             "train": ["entry_idle_ms.train", "cut_idle_ms.train",
                       "optimizer_idle_ms.train",
                       "host_syncs_per_step.train"]}[cell]
    for n in names:
        got = read(n, lay)
        assert (got is None if n not in reads
                else got == pytest.approx(reads[n])), (n, got)
