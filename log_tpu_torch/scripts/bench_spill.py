"""Training throughput with the Adam moments spilled to host memory, against
the device path; counterpart of scripts/bench_spill.py.

The moments move to pinned host memory past the optimizer's thresholds
(`SparseOptimizer.maybe_spill`: the second moments past `spill_points`,
the 50M-point tier; the first moments too past `spill_points_full`, the
100M-point tier). Here the thresholds are set just under the model's point
count so that `maybe_spill` engages at 100k points. Each mode trains the
same model, made from the same numpy seed, through `LoG.training_iteration`
at 1920x1088 over a 14-camera orbit (no tree: the init-stage geometry of
bench_trainstep): 2 warm-up steps, then the timed ones (a synchronize
around each). Reports ms per step, the bytes copied each way per step, and
whether the three modes' parameters and moments agree after the same steps
(bit for bit, else within SPILL_TOL). The steps keep the trainer's own pair
budget (8 tiles per slot of the slice bucket, as the JAX package's), so a
step whose demand passes it drops the rest, as in training; each step's
demand and budget are reported.

    python -m log_tpu_torch.scripts.bench_spill [n_points] [steps]
"""
from __future__ import annotations

import contextlib
import copy
import sys
import time

import numpy as np
import torch

from . import _common as C

H, W = 1088, 1920
MODES = {"device": (), "spill_sq": ("exp_avg_sq",),
         "spill_both": ("exp_avg", "exp_avg_sq")}
SPILL_TOL = (1e-5, 2e-6)  # rtol, atol: chip_smoke.py's spill phase
# scripts/bench_spill.py's model
SPILL_ARGS = {
    "gaussian": {"sh_degree": 1, "xyz_scale": 1.0},
    "tree": {"max_child": 4, "max_level": 30},
    "optimizer": {
        "optimize_keys": ["xyz", "colors", "scaling", "opacity", "rotation",
                          "shs"],
        "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016,
                    "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
                    "opacity": 0.05, "rotation": 0.001, "max_steps": 600},
    },
    "densify_and_remove": {},
}


def build_model(n: int, kinds: tuple, dev, seed: int = C.SEED):
    """The JAX script's model from a point cloud of n points, with the
    spill thresholds set so that maybe_spill moves `kinds` to the host."""
    from ..utils.config import load_object

    args = copy.deepcopy(SPILL_ARGS)
    lr = args["optimizer"]["lr_dict"]
    never = 1 << 62
    lr["spill_points"] = n - 1 if "exp_avg_sq" in kinds else never
    lr["spill_points_full"] = n - 1 if "exp_avg" in kinds else never
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-12, 12, n), rng.uniform(-12, 12, n),
                    rng.uniform(0, 2, n)], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, n).astype(np.float32)
    model = load_object("LoG.model.level_of_gaussian.LoG", args, device=dev)
    model.gaussian.register_by_pointcloud(xyz, colors, scales,
                                          init_opacity=0.5)
    model.counter.reset(model.num_points, model.capacity)
    model.counter.set_numpy(
        {"radius3d_min": np.full(model.num_points, 1e-4, np.float32),
         "radius3d_max": np.full(model.num_points, 10.0, np.float32)},
        model.capacity)
    model.base_iter = 10
    model.training_setup()
    engaged = model.optimizer.maybe_spill(model.num_points)
    if engaged != bool(kinds) or model.optimizer.spilled != tuple(
            sorted(kinds)):
        raise RuntimeError(f"maybe_spill moved {model.optimizer.spilled}, "
                           f"not {kinds}")
    return model


def step_budget(model) -> int:
    """The pair budget LoG gave its last step: 8 tiles per slot of the
    slice bucket (pick_max_pairs), from the prepare pass's bucket on the
    two-phase path, else the lagged bucket."""
    from ..ops import pick_max_pairs

    vf = model.visibility_flag or {}
    k = (vf["k_leaf"] + vf["k_node"] if "k_leaf" in vf
         else sum(model._bucket))
    return pick_max_pairs(k)


def state_of(model) -> dict:
    """Parameters and moments of the live rows, as host arrays."""
    return {k: np.array(v) for k, v in model.state_dict().items()
            if k.split(".")[0] in ("gaussian", "optimizer")}


def agreement(want: dict, got: dict) -> dict:
    """Bit-equal, or the largest difference and whether it is within
    SPILL_TOL, over every key."""
    if set(want) != set(got):
        raise KeyError(f"keys differ: {set(want) ^ set(got)}")
    bits = all(np.array_equal(want[k], got[k]) for k in want)
    worst = max(float(np.abs(want[k].astype(np.float64) - got[k]).max())
                for k in want if want[k].size)
    close = all(np.allclose(got[k], want[k], rtol=SPILL_TOL[0],
                            atol=SPILL_TOL[1]) for k in want)
    return {"bit_equal": bits, "max_abs_diff": worst, "within_tol": close}


def run(n_points: int = 100_000, steps: int = 12, warmup: int = 2,
        h: int = H, w: int = W, focal: float = 1400.0, device=None,
        hold=None) -> dict:
    dev = C.resolve_device(device)
    cams = [C.make_cam(2 * np.pi * i / 16, h, w, focal, height=12.0,
                       radius=16.0) for i in range(14)]
    rng = np.random.default_rng(7)
    gt = torch.from_numpy(rng.integers(0, 256, (3, h, w),
                                       dtype=np.uint8)).to(dev)
    bg = np.zeros(3, np.float32)
    out = {"metric": "spill_train_step_1080p", "card": C.card_line(dev),
           "n_points": n_points, "h": h, "w": w, "steps": steps}
    states = {}
    for mode, kinds in MODES.items():
        model = build_model(n_points, kinds, dev)
        for i in range(warmup):
            with (C.held(hold, f"{mode} step 0") if i == 0
                  else contextlib.nullcontext()):
                model.training_iteration(cams[i], gt, bg, view_index=0)
        moved0 = dict(model.optimizer.transfer_bytes)
        before = dict(C.kernels.LAUNCHES)
        C.reset_peak(dev)
        ms, losses, pairs, budgets = [], [], [], []
        for i in range(steps):
            C.sync(dev)
            t0 = time.perf_counter()
            metrics, _ = model.training_iteration(
                cams[2 + i % (len(cams) - 2)], gt, bg, view_index=0)
            C.sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            pairs.append(int(metrics["pair_total"]))
            budgets.append(step_budget(model))
        moved = model.optimizer.transfer_bytes
        states[mode] = state_of(model)
        out[mode] = {
            "spilled": list(model.optimizer.spilled), "steps": steps,
            "step_ms": ms,
            "step_ms_median": float(np.median(ms)),
            "step_ms_mean": float(np.mean(ms)),
            "h2d_bytes_per_step": (moved["h2d"] - moved0["h2d"]) / steps,
            "d2h_bytes_per_step": (moved["d2h"] - moved0["d2h"]) / steps,
            "peak_bytes": C.peak_bytes(dev), "loss": losses,
            "pairs_per_step": pairs, "budget_per_step": budgets,
            "budget_overflow": any(p > b for p, b in zip(pairs, budgets)),
            "finite": all(np.isfinite(v).all() for v in states[mode].values()
                          if v.dtype.kind == "f"),
            "launches": C.launches_since(before),
        }
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for mode in ("spill_sq", "spill_both"):
        out[mode]["vs_device"] = agreement(states["device"], states[mode])
        out[mode]["slowdown"] = (out[mode]["step_ms_median"]
                                 / out["device"]["step_ms_median"])
    out["modes_agree"] = all(out[m]["vs_device"]["within_tol"]
                             for m in ("spill_sq", "spill_both"))
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    if argv:
        kw["n_points"] = int(argv[0])
    if len(argv) > 1:
        kw["steps"] = int(argv[1])
    C.emit(run(**kw))


if __name__ == "__main__":
    main()
