"""The port's spans (utils/profiler.py `span`): one `vis` frame and one
`Trainer.training_step` under torch.profiler emit the spans of every layer,
nested as the program calls them, and a `sync.<site>` span around each
statement that waits for the device; with no profiler a span is the shared
null context and never reaches `record_function`."""
from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from log_tpu_torch.utils import profiler

PKG = Path(__file__).resolve().parents[1] / "log_tpu_torch"
CAM_KEYS = ("camera_center", "world_view_transform", "full_proj_transform",
            "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")
H, W = 32, 128

# (span, the span it sits in) on the benchmark cells' paths: the flat_slice
# frame with the per-frame root cull, the tree-stage step with the per-view
# gain
NESTING = {
    "view": [
        ("vis.camera", "vis"), ("render_fused", "vis"),
        ("vis.quantize", "vis"), ("sync.vis_copy", "vis"),
        ("render_fused.inputs", "render_fused"),
        ("sync.camera_device", "render_fused.inputs"),
        ("sync.render_fused_buckets", "render_fused.inputs"),
        ("sync.render_fused_background", "render_fused.inputs"),
        ("render_fused.cull", "render_fused"),
        ("cull.candidates", "render_fused.cull"),
        ("cull.check", "render_fused.cull"),
        ("cull.expand", "render_fused.cull"),
        ("sync.compact_fill", "cull.check"),
        ("raster.bin", "cull.check"), ("raster.composite", "cull.check"),
        ("render_fused.frame", "render_fused"),
        ("frame.cut", "render_fused.frame"),
        ("frame.act", "render_fused.frame"),
        ("frame.compact", "render_fused.frame"),
        ("frame.check", "render_fused.frame"),
        ("frame.pairs", "render_fused.frame"),
        ("frame.kernel", "render_fused.frame"),
    ],
    "train": [
        ("trainer.camera", "trainer.training_step"),
        ("trainer.gt", "trainer.training_step"),
        ("training_iteration", "trainer.training_step"),
        ("trainer.output", "trainer.training_step"),
        ("sync.step_gt", "trainer.output"),
        ("training_iteration.inputs", "training_iteration"),
        ("sync.training_iteration_buckets", "training_iteration.inputs"),
        ("sync.camera_device", "training_iteration.inputs"),
        ("sync.step_background", "training_iteration.inputs"),
        ("train_step.visibility", "training_iteration"),
        ("sync.compact_fill", "train_step.visibility"),
        ("train_step.compact", "training_iteration"),
        ("sync.compact_fill", "train_step.compact"),
        ("train_step.forward", "training_iteration"),
        ("raster.bin", "train_step.forward"),
        ("raster.composite", "train_step.forward"),
        ("train_step.loss", "training_iteration"),
        ("train_step.backward", "training_iteration"),
        ("train_step.update", "training_iteration"),
        ("train_step.counter", "train_step.update"),
        ("sync.counter_bincount", "train_step.counter"),
        ("train_step.adam", "train_step.update"),
        ("sync.adam_lr", "train_step.adam"),
        ("sync.adam_step", "train_step.adam"),
        ("train_step.clamp_correction", "train_step.update"),
        ("sync.correction_lr", "train_step.clamp_correction"),
        ("training_iteration.apply", "training_iteration"),
    ],
}
# the host syncs of one frame and one step: the sites that
# torch.cuda.set_sync_debug_mode("warn") finds on the card (PERF.md)
SYNCS = {
    "view": {"sync.camera_device": 3, "sync.render_fused_buckets": 1,
             "sync.render_fused_background": 1, "sync.compact_fill": 1,
             "sync.vis_copy": 1},
    "train": {"sync.training_iteration_buckets": 1, "sync.camera_device": 3,
              "sync.step_background": 1, "sync.compact_fill": 3,
              "sync.counter_bincount": 2, "sync.adam_lr": 6,
              "sync.adam_step": 6, "sync.correction_lr": 2,
              "sync.step_gt": 1},
}
TOP = {"view": "vis", "train": "trainer.training_step"}


def _model(split: str):
    """A 200-root synthetic tree (1,080 points), SH 1, flat_slice."""
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    args = {
        "use_view_correction": True,
        "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
        "optimizer": {"optimize_keys": ["xyz", "colors", "scaling",
                                        "opacity", "rotation", "shs"],
                      "opt_all_levels": True,
                      "lr_dict": {"xyz": 1.6e-4, "colors": 2.5e-3,
                                  "shs": 1.25e-4, "scaling": 5e-3,
                                  "opacity": 0.05, "rotation": 1e-3,
                                  "max_steps": 600}},
        "tree": {"max_child": 4, "cut_method": "flat_slice"},
        "densify_and_remove": {},
    }
    model = load_object("LoG.model.level_of_gaussian.LoG", args, device="cpu")
    if split == "train":
        model.view_correction.init(1)
    model.load_state_dict(build_checkpoint(200, seed=3))
    model.set_state(enable_sh=True)
    return model


def _batch():
    from log_tpu_torch.dataset.base import prepare_camera

    pos = np.array([0.0, -22.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    pc = prepare_camera({"K": np.array([[40.0, 0, W / 2], [0, 40.0, H / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": H,
                         "W": W, "center": pos.reshape(3, 1)}, 1, 0.01,
                        1000.0)
    return {"camera": {k: np.asarray(pc[k])[None] for k in CAM_KEYS},
            "image": np.random.default_rng(0).uniform(size=(1, H, W, 3)),
            "index": np.asarray([0])}


def _runner(kind: str):
    """A callable that serves one frame or makes one training step of the
    cell's kind. The first frame sizes its buckets in a prepare pass, and
    so do the first step (which takes the two-phase step) and the second
    (which has no counts of the last yet): the tests trace the third."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    batch = _batch()
    if kind == "view":
        model = _model("demo")
        model.eval()
        renderer = NaiveRendererAndLoss(split="demo", device="cpu")
        return lambda: renderer.vis(batch, model)
    model = _model("train")
    model.set_stage("tree")
    model.training_setup()
    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device="cpu")
    trainer = Trainer({}, model, renderer, seed=5)
    trainer.set_gt_cache(True)

    def step():
        trainer.global_iterations += 1   # off the logging cadence of 10
        return trainer.training_step(model, batch)

    return step


def _spans(prof, tmp_path):
    """[(name, parent name or None)] of the trace's user annotations."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    events.sort(key=lambda e: (e["tid"], float(e["ts"]), -float(e["dur"])))
    out, stack = [], []
    for e in events:
        t0 = float(e["ts"])
        while stack and (stack[-1][0] != e["tid"] or stack[-1][2] <= t0):
            stack.pop()
        out.append((e["name"], stack[-1][1] if stack else None))
        stack.append((e["tid"], e["name"], t0 + float(e["dur"])))
    return out


@pytest.mark.parametrize("kind", ["view", "train"])
def test_frame_and_step_spans(kind, monkeypatch, tmp_path):
    """Every span of the layer table, in the span the program opens it in;
    the top-level span once; the sync spans one for each wait the card's
    sync-debug pass counted; every span name under SPAN_ROOTS."""
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    run = _runner(kind)
    run()
    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _spans(prof, tmp_path)
    pairs = set(spans)
    missing = [p for p in NESTING[kind] if p not in pairs]
    assert not missing, missing
    assert [n for n, _ in spans].count(TOP[kind]) == 1
    assert (TOP[kind], None) in pairs
    syncs = Counter(n for n, _ in spans if n.startswith("sync."))
    assert dict(syncs) == SYNCS[kind]
    assert all(profiler.is_span(n) for n, _ in spans)
    assert not profiler.is_span("void rasterize_fwd_kernel<0, true>")


def test_run_stages_prefix(tmp_path):
    """run_stages(prefix=p) opens one p.<stage> span per stage, in stage
    order, and without a prefix none."""
    from log_tpu_torch.model.train_step import run_stages

    def stage(key):
        return lambda s: s.setdefault("order", []).append(key)

    stages = [(k, stage(k)) for k in ("cut", "act", "pairs", "kernel")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("frame"):
            state = run_stages(stages, prefix="frame")
        run_stages(stages, {})
    assert state["order"] == ["cut", "act", "pairs", "kernel"]
    assert _spans(prof, tmp_path) == [
        ("frame", None), ("frame.cut", "frame"), ("frame.act", "frame"),
        ("frame.pairs", "frame"), ("frame.kernel", "frame")]


@pytest.mark.parametrize("kind", ["view", "train"])
def test_spans_off_never_record(kind, monkeypatch):
    """With no profiler a span is the one shared null context and never
    calls record_function (patched here to raise); under the profiler it
    does."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    run = _runner(kind)
    monkeypatch.setattr(profiler, "record_function", refuse)
    assert profiler.span("vis") is profiler.span("sync.vis_copy")
    for _ in range(3):
        run()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            profiler.span("vis")


def test_no_record_function_outside_profiler():
    """span() is the only way the port opens a range."""
    found = [f"{p.relative_to(PKG)}:{i}"
             for p in sorted(PKG.rglob("*.py"))
             if p.name != "profiler.py" or p.parent.name != "utils"
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if re.search(r"\brecord_function\b", line)]
    assert not found, found
