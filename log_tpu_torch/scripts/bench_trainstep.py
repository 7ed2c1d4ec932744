"""The init-stage training step at 1920x1088 on 100k points; counterpart of
scripts/bench_trainstep.py.

The JAX script's state and GT, drawn on the device with the JAX package's
random numbers (utils/jax_random.py) from its keys, `split(PRNGKey(0), 8)`:
keys 0-6 draw positions over a 24 x 24 x 2 box, scales 0.05-0.3, rotations
(normalized normals), opacities 0.3-0.9 and colors, SH zero; key 7 the GT,
`uniform * 255` as uint8. No tree: `k_leaf` is the capacity, so
`fused_prepare_train_step` (the frustum test, then the step) takes the
identity path. The cameras are the JAX script's orbit (2 pi i / 22, height
12, radius 16); a run with more than 22 steps goes round again. The JAX
step also takes `PRNGKey(1)`, the key of its depth patches; the port's
step takes no key where it renders no depth. The JAX script
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
ORBIT_TURNS = 22  # the JAX script's STEPS + 2 poses around the orbit


def state_keys(seed: int = C.SEED) -> np.ndarray:
    """The JAX script's keys, jax.random.split(PRNGKey(seed), 8): 0-6 draw
    the state, 7 the GT."""
    from ..utils import jax_random as jr

    return jr.split(jr.prng_key(seed), 8)


def make_state(cap: int, dev, seed: int = C.SEED) -> dict:
    """Parameters of cap rows (all drawn), the JAX script's gen_state."""
    from ..utils import jax_random as jr

    ks = state_keys(seed)
    ext = 12.0

    def uniform(k, shape, lo=0.0, hi=1.0):
        return jr.uniform(ks[k], shape, lo, hi, dev)

    q = jr.normal(ks[4], (cap, 4), dev)
    opac = uniform(5, (cap, 1), 0.3, 0.9)
    return {
        "xyz": torch.stack([uniform(0, (cap,), -ext, ext),
                            uniform(1, (cap,), -ext, ext),
                            uniform(2, (cap,), 0.0, 2.0)], dim=1),
        "colors": uniform(6, (cap, 3)) * 2 - 1,
        "scaling": torch.log(uniform(3, (cap, 3), 0.05, 0.3)),
        "opacity": torch.log(opac / (1 - opac)),
        "rotation": q / torch.linalg.norm(q, dim=1, keepdim=True),
        "shs": torch.zeros((cap, 3, 3), device=dev),
    }


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


def random_gt(h: int, w: int, dev, key) -> torch.Tensor:
    """The JAX scripts' 8-bit GT: (uniform(key, (3, h, w)) * 255) as
    uint8."""
    from ..utils import jax_random as jr

    return (jr.uniform(key, (3, h, w), device=dev) * 255).to(torch.uint8)


def run(n_points: int = 100_000, steps: int = 20, warmup: int = 2,
        h: int = H, w: int = W, focal: float = 1400.0, device=None,
        hold=None) -> dict:
    from ..model.gaussian import next_capacity
    from ..model.train_step import StepConfig, fused_prepare_train_step
    from ..ops import pick_max_pairs

    dev = C.resolve_device(device)
    cap = next_capacity(n_points)
    params = make_state(cap, dev)
    moments, counter, lrs, corr = step_inputs(params, dev)
    zeros = torch.zeros(cap, dtype=torch.int32, device=dev)
    tree = {"node_index": zeros, "index_parent": zeros, "depth": zeros}
    k_bucket = next_capacity(n_points, 256)
    cfg = StepConfig(image_height=h, image_width=w, k_leaf=k_bucket, k_node=0,
                     sh_degree=0, mode="antialias", backend="tiled",
                     max_pairs=pick_max_pairs(k_bucket))
    cams = C.orbit(steps + warmup + 1, h, w, focal, dev, height=12.0,
                   radius=16.0, turns=ORBIT_TURNS)
    gt = random_gt(h, w, dev, state_keys()[7])
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
