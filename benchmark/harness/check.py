"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (benchmark/reference/) run on the same
checkpoint, cameras and images once the window has closed.

View cells compare each checked frame as it was served (the 8-bit frame
that `vis` put on the host, and the kept count of its cut from
`LoG.frame_stats()`) with the reference's frame of the same pose, culled
at the camera of the frame that last refreshed the program's cull:
- image_gap: the mean absolute difference of the two 8-bit frames, in
  levels, of the worst checked frame;
- cut_gap: |kept points - the reference's| / the reference's, worst frame.
Train cells compare the first steps that set-up drove through the
trainer with the reference's steps from the same checkpoint, views,
ground truth and backgrounds:
- loss_gap: the largest relative gap of a step's loss;
- grad_gap: per leaf (parameter kind), |norm of the Adam first moment
  after step 1 (the first gradient times 1 - beta1, on the rows it
  updated) - the reference's|, over the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf;
- change_gap: the same for the norm of the parameters' change after the
  compared steps.
Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone and are left out of grad_gap and
change_gap.

Each number compared has its limit in benchmark/limits/<cell>.json, set
between the largest reading of sound runs and the smallest of the
control (the reference one precision lower), with both readings beside
it; a number whose control does not read three times its sound runs has
no limit there and is not compared.
"""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent.parent / "limits"
NEGLIGIBLE = 1e-3


def limits_for(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def reference_mode():
    """float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def frame_gaps(served_u8, served_cut: int, ref: dict) -> dict:
    from ..reference.frame import quantize

    ref8 = quantize(ref["image"]).to(torch.int16)
    got = torch.as_tensor(served_u8, device=ref8.device).to(torch.int16)
    return {"image_gap": float((got - ref8).abs().float().mean()),
            "cut_gap": abs(served_cut - ref["cut"]) / max(ref["cut"], 1)}


def worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def leaf_gaps(prog: dict, ref: dict, counted) -> float:
    med = statistics.median(ref[k] for k in counted)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in counted)


def train_gaps(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "m1": {key: norm}, "change":
    {key: norm}}."""
    med = statistics.median(ref["m1"].values())
    counted = [k for k, v in ref["m1"].items() if v >= NEGLIGIBLE * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gaps(prog["m1"], ref["m1"], counted),
        "change_gap": leaf_gaps(prog["change"], ref["change"], counted),
    }


def judge(numbers: dict, limits: dict):
    """(correct, {name: [value, limit]}) for every number the cell's
    limits name; a number without a limit is read but not compared."""
    rows = {k: [numbers[k], lim] for k, lim in limits.items()}
    ok = all(v == v and v <= lim for v, lim in rows.values())
    return ok, rows
