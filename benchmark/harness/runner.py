"""One run of one cell: `python benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`.

The cell (BENCHMARK.json `workloads`) names a configuration, whose file
holds the model's arguments, the scene, the camera and the state the
program is put in, and a traffic mix, whose file under
benchmark/traffic/ names the loop that runs it (`kind`) and its
parameters, and may set the camera the cell renders at in place of the
configuration's (`inputs.camera_of`). With --trace 0 the run reports
the cell's end-to-end metrics; with --trace 1 a short traced window and
the per-layer metrics that list the cell under `workloads`, each read by
its own file under benchmark/metrics/ (`read(layer)`, None where it
finds nothing to read). Every run holds what its timed path produced
against the reference (harness/check.py) and prints each compared number
beside its limit, last on standard error and last in the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import check, train, view

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED = ("jax", "jaxlib", "flax", "log_tpu")
# each traffic file's `kind` and the loop that drives it
LOOPS = {"flythrough": view.run, "train-cycle": train.run}


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class Ctx:
    """What a traffic loop needs of the run."""

    def __init__(self, cell, cfg, traffic, device, seed, seconds, trace,
                 t_start):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.device, self.seed, self.seconds = device, seed, seconds
        self.trace, self.t_start = trace, t_start

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def since_start(self) -> float:
        self.sync()
        return time.time() - self.t_start

    def peak_bytes(self) -> int:
        import torch

        if not self.cuda:
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import torch

        if self.cuda:
            torch.cuda.empty_cache()



def reference_config(cfg: dict) -> dict:
    """The settings of the configuration that the reference follows."""
    model = cfg["model"]
    lr = dict(model["optimizer"]["lr_dict"],
              xyz_scale=model["gaussian"].get("xyz_scale", 1.0))
    return {"check_render_scale": model.get("check_render_scale", 1),
            "min_resolution_pixel": float(cfg.get("state", {}).get(
                "min_resolution_pixel", 3.0)),
            "sh_degree": model["gaussian"]["sh_degree"], "lr_dict": lr}


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Layer(dict):
    """The traced run's readings, as the metric files read them."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as exc:
            raise AttributeError(k) from exc


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, t_start=None, out=None) -> int:
    """Run one cell; returns the exit code. device=None asks for the card
    (and fails without enough of them); a test passes a CPU device."""
    t_start = process_start() if t_start is None else t_start
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}",
              file=sys.stderr)
        return 2
    wl = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < wl["chips"]):
            print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                  f"cuda available: {torch.cuda.is_available()}, devices: "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    ctx = Ctx(args.workload, cfg, traffic, device, args.seed, args.seconds,
              bool(args.trace), t_start)
    code, line = execute(ctx, bench, wl)
    if line is not None:
        print(json.dumps(line), file=out or sys.stdout, flush=True)
    return code


def execute(ctx, bench: dict, wl: dict):
    """Drive the cell's traffic on ctx and judge it. Returns (exit code,
    the result line or None)."""
    import torch

    ctx.cfg["ref"] = reference_config(ctx.cfg)
    with contextlib.redirect_stdout(sys.stderr):
        res = LOOPS[ctx.traffic["kind"]](ctx)

    cell, device = ctx.cell, ctx.device
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    metrics = {}
    line_device = {"platform": "gpu" if ctx.cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if ctx.cuda
                            else device.type),
                   "count": wl["chips"], "memory_peak_bytes": res["peak_bytes"]}
    breakdown = None
    if ctx.trace:
        lay = Layer(res["layer"])
        tr = lay["trace"]
        win = tr.window("bench.vis" if lay["kind"] == "view"
                        else "bench.training_step")
        lay.update(window=win, busy_s=tr.busy_s(win),
                   traced_s=(win[1] - win[0]) / 1e6)
        for m in bench["per_layer"]:
            if cell in m["workloads"]:
                v = load_metric(m["name"]).read(lay)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line_device.update(busy_s=lay["busy_s"], window_s=lay["traced_s"])
        breakdown = {"device_ops": tr.top_ops(win),
                     "idle_gaps": tr.idle_gaps(win)}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    if ctx.cuda:
        line_device["power"] = power_limit()
    limits = check.limits_for(cell)
    correct, rows = check.judge(res["numbers"], limits)
    failed = sum(not check.judge(r, limits)[0] for r in res["rows"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": failed, "metrics": metrics, "device": line_device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = rows
    print(f"reference: {res['ref_s']:.3f} s; read, not compared: "
          f"{ {k: v for k, v in res['numbers'].items() if k not in rows} }",
          file=sys.stderr)
    for k, (v, lim) in rows.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    # last, once every metric file has been loaded
    found = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3, None
    return 0, line
