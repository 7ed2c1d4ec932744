"""Compute ops: rasterization backends, math, and the CUDA kernel wrappers.

`pick_backend` / `pick_max_pairs` centralize the runtime choice between the
plain reference rasterizer (the oracle) and the tiled production path, and
the static pair budget of the tiled path; `budget_for_demand` sizes a
budget from a frame's measured pair demand.
"""
from __future__ import annotations

import os

import torch


def pick_backend(num_points: int | None = None, *, device) -> str:
    """The LOG_TPU_BACKEND override where it is set (on any device: the
    oracle run trains with "reference"); else 'tiled' on a CUDA device,
    and on the CPU the oracle for small scenes and the tiled path (plain
    versions of its kernels) above 16384 points, where O(P*HW) costs
    more. `device` has no default: a call that does not say where it runs
    would otherwise pick the oracle on the card for a small tree."""
    env = os.environ.get("LOG_TPU_BACKEND")
    if env:
        return env
    if torch.device(device).type == "cuda":
        return "tiled"
    if num_points is not None and num_points > 16384:
        return "tiled"
    return "reference"


PAIR_RAIL = 1 << 23


def pick_max_pairs(k_visible: int, per_point: int = 8) -> int:
    """Static pair capacity for a visible-set bucket (~per_point
    tiles/gaussian headroom, floor 64k, cap 8M), in 1.5x steps. The cap is a
    safety rail for worst-case sizing, not a truncation license: callers
    that know the frame's measured demand size from it with
    `budget_for_demand`."""
    cap = 1 << 16
    need = k_visible * per_point
    while cap < need and cap < PAIR_RAIL:
        nxt = cap + cap // 2
        cap = nxt if nxt >= need else cap * 2
    return min(cap, PAIR_RAIL)


def budget_for_demand(need: int) -> int:
    """The pair budget for a measured demand: pick_max_pairs(need,
    per_point=1)'s 1.5x steps from 64k, without its rail, so that a frame
    past 2^23 pairs keeps all of them."""
    cap = 1 << 16
    while cap < need:
        nxt = cap + cap // 2
        cap = nxt if nxt >= need else cap * 2
    return cap
