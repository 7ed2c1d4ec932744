"""Level-of-Gaussian tree as flat arrays; counterpart of
log_tpu/model/tensor_tree.py.

* The host tree (numpy) holds the structure; its shape-changing ops
  (initialize / split / remove, run at densification cadence) come with the
  training slice.
* Per-camera cut selection runs on the device every frame as a per-point
  predicate over all points: `traverse_cut` walks the levels with parent
  gathers (the exact BFS equivalent), `flat_cut` needs one gather given the
  cached parent radii.
"""
from __future__ import annotations

import numpy as np
import torch


class TensorTree:
    """Flat-tensor N-ary tree over point indices (host arrays)."""

    KEYS = ("node_index", "index_parent", "local_index", "depth", "root_id")

    def __init__(self, max_child: int = 2, max_level: int = 20,
                 cut_method: str = "flat"):
        self.max_child = max_child
        self.max_level = max_level
        # 'flat' (one-gather predicate) or 'traverse' (per-level loop)
        self.cut_method = cut_method
        self.root_index = np.zeros((0,), np.int32)
        self.node_index = np.zeros((0,), np.int32) - 1
        self.index_parent = np.zeros((0,), np.int32) - 1
        self.local_index = np.zeros((0,), np.int32)
        self.depth = np.zeros((0,), np.int32)
        # row of this point's root ancestor (== own row for roots)
        self.root_id = np.zeros((0,), np.int32)
        self.tree = np.zeros((0, max_child), np.int32) - 1
        self.min_resolution_pixel = 3.0
        self.log_query = False

    @property
    def num_points(self) -> int:
        return self.node_index.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.tree.shape[0]

    @property
    def is_leaf(self) -> np.ndarray:
        return self.node_index == -1

    @property
    def is_root(self) -> np.ndarray:
        return self.index_parent == -1

    def __repr__(self):
        num_parents = int((self.node_index > -1).sum())
        num_leaves = int((self.node_index == -1).sum())
        return (
            f"Tree: {self.num_points} points:{num_parents} parents, "
            f"{num_leaves} leaves, {self.num_nodes} nodes"
        )

    def ensure_root_id(self) -> None:
        """Reconstruct root_id by walking parents when it is missing."""
        n = self.num_points
        if getattr(self, "root_id", None) is not None and \
                self.root_id.shape[0] == n:
            return
        rid = np.arange(n, dtype=np.int32)
        depth_max = int(self.depth.max()) if n else 0
        for d in range(1, depth_max + 1):
            m = self.depth == d
            rid[m] = rid[self.index_parent[m].astype(np.int64)]
        self.root_id = rid

    def device_arrays(self, capacity: int, device) -> dict:
        """Capacity-padded device copies of the per-point tree arrays."""
        def pad(a, fill):
            out = np.full((capacity,), fill, np.int32)
            out[: a.shape[0]] = a
            return torch.from_numpy(out).to(device)

        return {
            "node_index": pad(self.node_index, -1),
            "index_parent": pad(self.index_parent, -1),
            "depth": pad(self.depth, 0),
        }


def traverse_cut(node_index, index_parent, depth, radius2d, root_visible,
                 alive_mask, min_resolution_pixel, max_depth, num_levels: int):
    """Per-point LoD cut predicate, level by level: a node is kept iff it is
    reached (every proper ancestor descended) and (projected radius <
    min_pixel OR leaf OR depth >= max_depth). Returns bool (capacity,)."""
    is_root = index_parent == -1
    is_leaf = node_index == -1
    small = radius2d < min_resolution_pixel
    parent_safe = torch.clamp(index_parent, min=0).to(torch.int64)
    keep = torch.zeros_like(is_root)
    desc = torch.zeros_like(is_root)
    for d in range(num_levels):
        at_d = (depth == d) & alive_mask
        reached = torch.where(is_root, root_visible, desc[parent_safe]) & at_d
        keep = keep | (reached & (small | is_leaf | (d >= max_depth)))
        desc = desc | (reached & ~small & ~is_leaf & (d < max_depth))
    return keep


def flat_cut(index_parent, node_index, depth, root_id, radius2d,
             radius2d_parent, root_visible, alive_mask, min_resolution_pixel,
             max_depth):
    """One-gather LoD cut: equal to `traverse_cut` whenever the projected
    radius does not grow from parent to child (the parent is then the
    smallest ancestor); radius2d_parent comes from the parent-attribute
    cache, so the only gather left is root_visible[root_id]."""
    is_root = index_parent == -1
    is_leaf = node_index == -1
    small = radius2d < min_resolution_pixel
    parent_big = radius2d_parent >= min_resolution_pixel
    root_vis = root_visible[torch.clamp(root_id, min=0).to(torch.int64)]
    reach = root_vis & torch.where(is_root, True,
                                   parent_big & (depth <= max_depth))
    return alive_mask & reach & (small | is_leaf | (depth >= max_depth))
