"""The training step's dissection on the port: cumulative prefixes of the
init-stage step at 1920x1088; counterpart of
scripts/bench_trainstep_dissect.py.

The state is bench_trainstep's (the JAX script's 100k random points over
24 x 24 x 2 and its GT, no tree, SH 0) after its two warm-up steps, so
the step takes the identity path and its ~21.6M pairs a step pass 2^24:
the unpacked route, K3. Each
prefix runs the port's own stages from that same state
(`train_step.prepare_visibility`, then `train_step.train_step_stages`,
whose `run_stages` is the step itself):

  prep        the visibility pass (the frustum test over the capacity)
  compact     + the step's rows (`_step_slices`; identity: no compaction)
  fwd         + activation and the tiled render with full stats (K4, K3,
              the pair sort, K1)
  fwd_l1      + the L1 term alone (a probe, not a stage of the step)
  fwd_loss    + the step's loss, 0.8 L1 + 0.2 SSIM
  fwd_bwd_l1  the gradients of the L1 term alone (K2 and the binning's VJPs)
  fwd_bwd     the gradients of the step's loss
  full        + counters, Adam, the scale clamp: the whole step, whose
              result equals fused_prepare_train_step's bit for bit
              (checked once: "full_equals_step")

Each prefix is a `_common.time_stage` row (host ms, device ms, launches,
syncs, peak); "itemized" gives the differences of consecutive prefixes.
The JAX script gives the step `pick_max_pairs(k_bucket)`; here the
warm-up steps measure the unclamped demand and the prefixes run at a
budget that holds it (`budget_for_demand`), the script's budget reported
beside it. Every timed call's demand must be at or under its budget. The
optional forced bucket k_bucket gives the tree-stage regime (a small
slice against a large capacity; its overflow truncates the cut, as in the
JAX script).

    python -m log_tpu_torch.scripts.bench_trainstep_dissect [n_points]
        [k_bucket] [--reps R]
"""
from __future__ import annotations

import argparse

import torch

from . import _common as C
from .bench_trainstep import (H, W, make_state, random_gt, state_keys,
                              step_inputs)

PREFIXES = ("prep", "compact", "fwd", "fwd_l1", "fwd_loss", "fwd_bwd_l1",
            "fwd_bwd", "full")


class StepDissector:
    """The step's state and its prefix functions."""

    def __init__(self, n_points, k_bucket, h, w, focal, dev):
        from ..model.gaussian import next_capacity
        from ..model.train_step import StepConfig
        from ..ops import pick_max_pairs

        self.dev, self.n = dev, n_points
        self.cap = cap = next_capacity(n_points)
        self.params = make_state(cap, dev)
        (self.moments, self.counter, self.lrs,
         self.corr) = step_inputs(self.params, dev)
        zeros = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.tree = {"node_index": zeros, "index_parent": zeros,
                     "depth": zeros}
        self.k_bucket = k_bucket or next_capacity(n_points, 256)
        self.cfg = StepConfig(image_height=h, image_width=w,
                              k_leaf=self.k_bucket, k_node=0, sh_degree=0,
                              mode="antialias", backend="tiled",
                              max_pairs=pick_max_pairs(self.k_bucket))
        self.cams = C.orbit(24, h, w, focal, dev, height=12.0, radius=16.0)
        self.gt = random_gt(h, w, dev, state_keys()[7])
        self.bg = torch.zeros(3, device=dev)
        self.ones = torch.ones((1, 1, 1), device=dev)
        self.leaf_opt = torch.zeros(cap, dtype=torch.bool, device=dev)
        self.prep_budget = pick_max_pairs(cap)
        self.it = 0
        self.seen = []

    def prep(self, cam):
        from ..model.train_step import prepare_visibility

        return prepare_visibility(
            self.params, self.tree, cam, self.n, self.leaf_opt, 3.0, 0,
            self.cfg.image_height, self.cfg.image_width, False, 1,
            "antialias", "tiled", self.prep_budget, C.CHECK_SCALE)

    def stages(self, cam, keep_leaf, keep_node, cfg):
        from ..model.train_step import train_step_stages

        return train_step_stages(
            self.params, self.moments, self.counter, keep_leaf, keep_node,
            cam, self.gt, self.bg, self.lrs, 1.0, self.corr, 0, self.ones,
            None, cfg)

    def prefix(self, name, cfg):
        """One call of prefix `name` on the next camera of the orbit, from
        the same state; the render's pair demand goes to self.seen."""
        from ..model.train_step import run_stages

        cam = self.cams[self.it % len(self.cams)]
        self.it += 1
        keep_leaf, keep_node, counts = self.prep(cam)
        if name == "prep":
            return counts
        st = dict(self.stages(cam, keep_leaf, keep_node, cfg))
        order = {"compact": ["compact"], "fwd": ["compact", "forward"],
                 "fwd_l1": ["compact", "forward", "l1"],
                 "fwd_loss": ["compact", "forward", "loss"],
                 "fwd_bwd_l1": ["compact", "forward", "l1", "backward"],
                 "fwd_bwd": ["compact", "forward", "loss", "backward"],
                 "full": ["compact", "forward", "loss", "backward",
                          "update"]}[name]
        st["l1"] = self.l1_stage
        s = run_stages([(k, st[k]) for k in order])
        if "out" in s:
            self.seen.append(s["out"]["pair_total"])
        return s

    def step(self, cam, cfg):
        """fused_prepare_train_step on the prefixes' state and arguments."""
        from ..model.train_step import fused_prepare_train_step

        return fused_prepare_train_step(
            self.params, self.moments, self.counter, self.tree, self.n,
            self.leaf_opt, 3.0, 0, cam, self.gt, self.bg, self.lrs, 1.0,
            self.corr, 0, self.ones, None, stage_has_tree=False,
            num_levels=1, prep_backend="tiled",
            prep_max_pairs=self.prep_budget, check_scale=C.CHECK_SCALE,
            cfg=cfg)

    def l1_stage(self, s):
        gt_f = self.gt.to(torch.float32) * (1.0 / 255.0)
        with torch.enable_grad():
            s["loss"] = torch.mean(torch.abs(s["out"]["render"] - gt_f))


def run(n_points: int = 100_000, k_bucket: int = 0, reps: int = 10,
        warmup: int = 2, h: int = H, w: int = W, focal: float = 1400.0,
        device=None, hold=None) -> dict:
    """The prefixes' rows on the state after `warmup` steps, at a budget
    sized from the warm-up steps' demand; hold(label) wraps the first full
    step (chip_smoke.py holds its kernel calls against the plain
    versions). Raises where a timed call's demand passed its budget.

    The warm-up steps are bench_trainstep's: they run at the script's
    budget and advance the state. The first one clamps every updated
    row's scale into the fresh counter's radius bounds (1, 1), which is
    what gives bench_trainstep's later steps their ~21.6M pairs."""
    import dataclasses

    from ..ops import budget_for_demand

    dev = C.resolve_device(device)
    d = StepDissector(n_points, k_bucket, h, w, focal, dev)
    demand = 0
    for i in range(warmup):
        res = d.step(d.cams[i], d.cfg)
        d.params, d.moments, d.counter, d.corr = res[:4]
        demand = max(demand, int(res[4]["pair_total"]))
    budget = max(d.cfg.max_pairs, budget_for_demand(int(demand * C.REBUMP)))
    cfg = dataclasses.replace(d.cfg, max_pairs=budget)
    d.it = warmup
    with C.held(hold, "dissect trainstep"):
        got = d.prefix("full", cfg)["result"]
    want = d.step(d.cams[warmup], cfg)
    same = torch.equal(got[4]["loss"], want[4]["loss"]) and all(
        torch.equal(g[k], w[k])
        for g, w in ((got[0], want[0]),
                     (got[1]["exp_avg"], want[1]["exp_avg"]),
                     (got[1]["exp_avg_sq"], want[1]["exp_avg_sq"]),
                     (got[2], want[2]))
        for k in w)
    del got, want
    d.seen.clear()
    rows = [C.time_stage(name, lambda name=name: d.prefix(name, cfg), reps,
                         dev) for name in PREFIXES]
    demands = [int(x) for x in d.seen]
    ms = {r["stage"]: r for r in rows}

    def diff(a, b, key):
        x, y = ms[a][key], (ms[b][key] if b else 0.0)
        return None if x is None or y is None else x - y

    items = (("prep", "prep", None), ("compact", "compact", "prep"),
             ("render_fwd", "fwd", "compact"),
             ("ssim_fwd", "fwd_loss", "fwd_l1"),
             ("render_bwd", "fwd_bwd_l1", "fwd_l1"),
             ("optimizer_tail", "full", "fwd_bwd"))
    itemized = {k: {"host_ms": diff(a, b, "host_ms"),
                    "device_ms": diff(a, b, "device_ms")}
                for k, a, b in items}
    itemized["ssim_bwd_extra"] = {
        key: (None if ms["fwd_bwd"][key] is None else
              (ms["fwd_bwd"][key] - ms["fwd_bwd_l1"][key])
              - (ms["fwd_loss"][key] - ms["fwd_l1"][key]))
        for key in ("host_ms", "device_ms")}
    out = {"metric": "trainstep_dissect_1080p", "card": C.card_line(dev),
           "warmup": warmup, "n_points": n_points, "capacity": d.cap,
           "k_bucket": d.k_bucket,
           "identity": d.k_bucket == d.cap, "h": h, "w": w, "reps": reps,
           "call_budget": d.cfg.max_pairs, "warmup_demand": demand,
           "max_pairs": budget, "pairs_measured": max(demands),
           "full_equals_step": same,
           "budget_overflow": max(demands) > budget, "prefixes": rows,
           "itemized": itemized}
    if out["budget_overflow"]:
        raise RuntimeError(f"a timed call's pair demand {max(demands)} "
                           f"passed its budget {budget}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_points", nargs="?", type=int, default=100_000)
    ap.add_argument("k_bucket", nargs="?", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    C.emit(run(a.n_points, a.k_bucket, a.reps))


if __name__ == "__main__":
    main()
