"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or log_tpu (log_tpu_torch is another name), and the reference nothing of
log_tpu_torch. Each check runs in a fresh interpreter."""
from __future__ import annotations

import subprocess
import sys

import pytest

from conftest import CELLS, FIRST, ROOT

RUN = """
import os, sys, time, json
sys.path.insert(0, {root!r})
os.environ["LOG_TPU_BACKEND"] = "tiled"
import torch
sys.path.insert(0, {tests!r})
from conftest import cell_files, shrink, bench, SEED
from benchmark.harness import runner
wl, cfg, tr = cell_files({cell!r})
cfg, tr = shrink(cfg, tr)
ctx = runner.Ctx(wl["name"], cfg, tr, torch.device("cpu"), SEED, 0.2,
                 {trace}, time.time())
code, line = runner.execute(ctx, bench(), wl)
assert code == 0 and line["correct"], line
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import sys, json
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark.harness import inputs
from benchmark.reference import frame, math, step
ck = inputs.make_tree(200, 5, 1, "cpu")
cam = inputs.orbit(5, 4, 64, 256, 200.0, 18.0, 22.0)[0]
cfg = dict(check_render_scale=4, min_resolution_pixel=3.0, sh_degree=1)
frame.frame(ck, cam, cfg, np.zeros(3, np.float32), math.F32)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str, **fmt) -> set:
    import json

    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           tests=str(ROOT / "benchmark"
                                                     / "tests"), **fmt)],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell,trace", [(FIRST["flythrough"], False)]
                         + [(cell, True) for cell in CELLS])
def test_run_loads_no_jax(cell, trace):
    """A whole run as far as its result line: each cell traced, with every
    per-layer metric file it lists loaded, and the first view cell
    untraced."""
    mods = _top_level_modules(RUN, cell=cell, trace=trace)
    assert "log_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "log_tpu"}


def test_reference_loads_no_port():
    mods = _top_level_modules(REF)
    assert not mods & {"log_tpu_torch", "jax", "jaxlib", "flax", "log_tpu"}


def test_late_import_refused(run_cell, monkeypatch):
    """A module of JAX that a per-layer metric file loads, after the
    traffic loop has ended, still stops the run: no result, a code other
    than 0."""
    import types

    from benchmark.harness import runner

    real = runner.load_metric

    def load_metric(name):
        mod = real(name)
        read = mod.read

        def read_and_import(lay):
            monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
            return read(lay)

        return types.SimpleNamespace(read=read_and_import)

    monkeypatch.setattr(runner, "load_metric", load_metric)
    code, line = run_cell(FIRST["flythrough"], trace=1)
    assert code != 0 and line is None
