"""The init-stage training step at 1920x1088 on 100k points; counterpart of
scripts/bench_trainstep.py.

The state is made from a numpy seed with the JAX script's distributions
(positions over a 24 x 24 x 2 box, scales 0.05-0.3, opacities 0.3-0.9, SH
zero), no tree: `k_leaf` is the capacity, so `fused_prepare_train_step`
(the frustum test, then the step) takes the identity path. The JAX script
gives the step a pair budget of 8 tiles per point (`pick_max_pairs`),
which this geometry's demand passes many times over (the step then drops
the pairs past it); here the warm-up steps measure the demand and the
timed steps run at a budget that holds it (_common.honest_steps), with the
script's budget reported beside it. Reports the median of the timed steps
(a synchronize around each) and the peak device memory over them.

    python -m log_tpu_torch.scripts.bench_trainstep [n_points] [steps]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import _common as C

H, W = 1088, 1920
KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")


def make_state(n: int, cap: int, dev, seed: int = C.SEED) -> dict:
    """Parameters of cap rows (all drawn; the first n alive)."""
    rng = np.random.default_rng(seed)
    ext = 12.0
    q = rng.standard_normal((cap, 4))
    opac = rng.uniform(0.3, 0.9, (cap, 1))
    params = {
        "xyz": np.stack([rng.uniform(-ext, ext, cap),
                         rng.uniform(-ext, ext, cap),
                         rng.uniform(0.0, 2.0, cap)], axis=1),
        "colors": rng.uniform(0.0, 1.0, (cap, 3)) * 2 - 1,
        "scaling": np.log(rng.uniform(0.05, 0.3, (cap, 3))),
        "opacity": np.log(opac / (1 - opac)),
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "shs": np.zeros((cap, 3, 3)),
    }
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in params.items()}


def step_inputs(params: dict, dev, lr: float = 1e-3):
    """Zero moments, a fresh counter, the learning rates and a one-view
    gain state, as the JAX script passes them."""
    from ..model.counter import init_counter

    cap = params["xyz"].shape[0]
    return ({mk: {k: torch.zeros_like(v) for k, v in params.items()}
             for mk in ("exp_avg", "exp_avg_sq")},
            {k: torch.from_numpy(v).to(dev)
             for k, v in init_counter(cap).items()},
            {k: lr for k in KEYS},
            {"values": torch.ones((1, 3), device=dev),
             "m1": torch.zeros((1, 3), device=dev),
             "m2": torch.zeros((1, 3), device=dev),
             "vmax": torch.zeros((1, 3), device=dev),
             "steps": torch.zeros((1,), dtype=torch.int32, device=dev)})


def random_gt(h: int, w: int, dev, seed: int = 7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (3, h, w),
                                         dtype=np.uint8)).to(dev)


def run(n_points: int = 100_000, steps: int = 20, warmup: int = 2,
        h: int = H, w: int = W, focal: float = 1400.0, device=None,
        hold=None) -> dict:
    from ..model.gaussian import next_capacity
    from ..model.train_step import StepConfig, fused_prepare_train_step
    from ..ops import pick_max_pairs

    dev = C.resolve_device(device)
    cap = next_capacity(n_points)
    params = make_state(n_points, cap, dev)
    moments, counter, lrs, corr = step_inputs(params, dev)
    zeros = torch.zeros(cap, dtype=torch.int32, device=dev)
    tree = {"node_index": zeros, "index_parent": zeros, "depth": zeros}
    k_bucket = next_capacity(n_points, 256)
    cfg = StepConfig(image_height=h, image_width=w, k_leaf=k_bucket, k_node=0,
                     sh_degree=0, mode="antialias", backend="tiled",
                     max_pairs=pick_max_pairs(k_bucket))
    cams = C.orbit(steps + warmup + 1, h, w, focal, dev, height=12.0,
                   radius=16.0)
    gt = random_gt(h, w, dev)
    bg = torch.zeros(3, device=dev)
    ones = torch.ones((1, 1, 1), device=dev)
    leaf_opt = torch.zeros(cap, dtype=torch.bool, device=dev)
    state = [params, moments, counter, corr]

    def step(i, cfg):
        p, m, c, co, metrics, _ = fused_prepare_train_step(
            *state[:3], tree, n_points, leaf_opt, 3.0, 0, cams[i], gt, bg,
            lrs, float(i + 1), state[3], 0, ones, None,
            stage_has_tree=False, num_levels=1, prep_backend="tiled",
            prep_max_pairs=pick_max_pairs(cap), check_scale=C.CHECK_SCALE,
            cfg=cfg)
        state[:] = [p, m, c, co]
        return metrics

    out = C.honest_steps(step, cfg, steps, warmup, dev, hold,
                         "trainstep step")
    out.update({
        "metric": "train_step_1080p_init_stage", "card": C.card_line(dev),
        "n_points": n_points, "capacity": cap, "k_leaf": k_bucket,
        "identity": k_bucket == cap, "h": h, "w": w,
        "finite": C.finite({"p": state[0], "m": state[1]})})
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
