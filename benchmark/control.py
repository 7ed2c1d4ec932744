"""The readings that a cell's limits are set from, at the cell's own size
(run on the card; the benchmark's runs do not run this):

- the control: the reference put in the program's place and computed one
  precision lower (`reference.math.CONTROL`: bfloat16 where the program
  computes float32, float8 e4m3 splat records where it packs bfloat16),
  held against the float32 reference as a run holds the program;
- for a training cell, the fault of a step that leaves half of the image
  out of its loss (the mean over the other half), planted in the
  reference put in the program's place. (A step that returns its state
  unchanged reads 1 by the change measure and needs no run.)

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed: {"seed", "control": {...}, "half_batch":
{...} (training)}, each with every number read ("readings") and the
cell's own judgement of them (`check.judge` against
benchmark/limits/<cell>.json: "correct", which the control and the fault
have to read false, and "checks", each compared number beside its
limit).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check, inputs, runner  # noqa: E402
from benchmark.harness.view import loop_cull_pose  # noqa: E402
from benchmark.reference import frame as ref_frame  # noqa: E402
from benchmark.reference import math as ref_math  # noqa: E402
from benchmark.reference.step import Trainer  # noqa: E402


def view_readings(cfg: dict, tr: dict, seed: int, dev, prec=ref_math.CONTROL):
    """The control's view numbers on check_frames frames of a window,
    drawn from the seed, as a run checks them."""
    ckpt = inputs.make_tree(cfg["scene"]["n_roots"], seed,
                            cfg["model"]["gaussian"]["sh_degree"], dev)
    cam = inputs.camera_of(cfg, tr)
    cams = inputs.orbit(seed, tr["poses"], cam["height"], cam["width"],
                        cam["focal"], tr["height"], tr["radius"])
    rng = np.random.default_rng(seed % (1 << 63))
    frames = rng.integers(tr["warmup_frames"],
                          tr["warmup_frames"] + 4 * tr["poses"],
                          tr["check_frames"])
    bg = np.asarray(tr["background"], np.float32)
    rows = []
    for i in frames.tolist():
        pose, cull = i % len(cams), cams[loop_cull_pose(i, cfg, cams)]
        got = ref_frame.frame(ckpt, cams[pose], cfg["ref"], bg, prec,
                              cull_camera=cull)
        ref = ref_frame.frame(ckpt, cams[pose], cfg["ref"], bg,
                              ref_math.F32, cull_camera=cull)
        rows.append(check.frame_gaps(ref_frame.quantize(got["image"]),
                                     got["cut"], ref))
    return check.worst(rows)


def train_readings(cfg: dict, tr: dict, seed: int, dev):
    """{"control": numbers, "half_batch": numbers}: the train numbers of
    the reference at the control's precision, and of the float32 reference
    with the half-batch fault, each against the float32 reference."""
    ckpt = inputs.make_tree(cfg["scene"]["n_roots"], seed,
                            cfg["model"]["gaussian"]["sh_degree"], dev)
    cam = inputs.camera_of(cfg, tr)
    V = tr["views"]
    cams = inputs.orbit(seed, V, cam["height"], cam["width"], cam["focal"],
                        tr["height"], tr["radius"])
    gts = inputs.ground_truth(seed, V, cam["height"], cam["width"],
                              tr["gt_cells"], dev)
    bg_rng = np.random.default_rng(seed % (1 << 63))
    bgs = [bg_rng.random(3).astype(np.float32)
           for _ in range(tr["compared_steps"])]

    def steps(prec, half):
        t = Trainer(ckpt, cfg["ref"], prec, half_batch=half)
        o = {"losses": []}
        for k in range(tr["compared_steps"]):
            r = t.step(cams[k % V], gts[k % V], bgs[k])
            o["losses"].append(r["loss"])
            if k == 0:
                o["m1"] = r["m1_norm"]
        o["change"] = t.change_norms(ckpt)
        return o

    ref = steps(ref_math.F32, False)
    return {"control": check.train_gaps(steps(ref_math.CONTROL, False), ref),
            "half_batch": check.train_gaps(steps(ref_math.F32, True), ref)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((runner.ROOT / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((runner.ROOT / conf["file"]).read_text())
    cfg["ref"] = runner.reference_config(cfg)
    tr = json.loads((runner.BENCH / "traffic" / f"{wl['traffic']}.json")
                    .read_text())
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    check.reference_mode()
    limits = check.limits_for(args.workload)
    for seed in args.seeds:
        if tr["kind"] == "flythrough":
            read = {"control": view_readings(cfg, tr, seed, dev)}
        else:
            read = train_readings(cfg, tr, seed, dev)
        row = {"seed": seed}
        for name, numbers in read.items():
            correct, rows = check.judge(numbers, limits)
            row[name] = {"correct": correct, "readings": numbers,
                         "checks": rows}
        print(json.dumps(row), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
