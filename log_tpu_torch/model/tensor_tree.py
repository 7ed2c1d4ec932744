"""Level-of-Gaussian tree as flat arrays; counterpart of
log_tpu/model/tensor_tree.py.

* The host tree (numpy) holds the structure; its shape-changing ops
  (initialize / split / remove) run on the host at densification cadence:
  a split appends num_split * max_child children, a remove compacts the
  rows and renumbers by cumsum.
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

    def initialize(self, num_points: int, flag: np.ndarray | None = None) -> None:
        """Every point becomes a root (a leaf without parent)."""
        root_index = np.arange(num_points, dtype=np.int32)
        if flag is None:
            print(f"[{self.__class__.__name__}] initialize tree: "
                  f"{num_points} points")
        else:
            print(f"[{self.__class__.__name__}] initialize tree: "
                  f"{int(flag.sum())}/{num_points} points")
            root_index = root_index[flag]
        self.root_index = root_index
        self.node_index = np.full((num_points,), -1, np.int32)
        self.index_parent = np.full((num_points,), -1, np.int32)
        self.local_index = np.full((num_points,), -1, np.int32)
        self.depth = np.zeros((num_points,), np.int32)
        self.root_id = np.arange(num_points, dtype=np.int32)
        self.tree = np.zeros((0, self.max_child), np.int32) - 1

    def __repr__(self):
        num_parents = int((self.node_index > -1).sum())
        num_leaves = int((self.node_index == -1).sum())
        return (
            f"Tree: {self.num_points} points:{num_parents} parents, "
            f"{num_leaves} leaves, {self.num_nodes} nodes"
        )

    def print_level(self):
        depth_max = int(self.depth.max()) if self.num_points else 0
        print(f"[{self.__class__.__name__}] tree level: {depth_max + 1}")
        for i in range(depth_max + 1):
            print("  " * (i + 1), f"level {i}: {int((self.depth == i).sum())}")

    # ------------------------------------------------------- structural ops
    def split(self, parent_index: np.ndarray) -> None:
        """Append max_child children per parent: the parents become nodes,
        the children leaves one level deeper, in parent order."""
        parent_index = np.asarray(parent_index, np.int64)
        num_split = len(parent_index)
        self.node_index[parent_index] = (
            np.arange(num_split, dtype=np.int32) + self.num_nodes
        )
        child_index = (
            np.arange(num_split * self.max_child, dtype=np.int32)
            + self.num_points
        ).reshape(num_split, self.max_child)
        self.tree = np.concatenate([self.tree, child_index], axis=0)
        num_new = num_split * self.max_child
        index_parent = np.repeat(parent_index.astype(np.int32), self.max_child)
        depth = np.repeat(self.depth[parent_index], self.max_child) + 1
        local_index = np.tile(np.arange(self.max_child, dtype=np.int32),
                              num_split)
        self.node_index = np.concatenate(
            [self.node_index, np.full((num_new,), -1, np.int32)])
        self.index_parent = np.concatenate([self.index_parent, index_parent])
        self.depth = np.concatenate([self.depth, depth])
        self.local_index = np.concatenate([self.local_index, local_index])
        self.root_id = np.concatenate(
            [self.root_id, np.repeat(self.root_id[parent_index],
                                     self.max_child)])

    def remove(self, index: np.ndarray) -> None:
        """Remove leaf points, compact the rows and renumber the
        references to them; a node whose children are all gone becomes a
        leaf again."""
        index = np.asarray(index, np.int64)
        parent_index = self.index_parent[index].astype(np.int64)
        local_index = self.local_index[index].astype(np.int64)
        node_index = self.node_index[parent_index].astype(np.int64)
        children_index = self.tree[node_index, local_index].astype(np.int64)
        self.tree[node_index, local_index] = -1
        flag_keep = np.ones((self.num_points,), bool)
        flag_keep[children_index] = False
        for key in self.KEYS:
            setattr(self, key, getattr(self, key)[flag_keep])
        left_index = np.cumsum(flag_keep) - 1
        flag_node_keep = self.tree > -1
        self.tree[flag_node_keep] = left_index[
            self.tree[flag_node_keep].astype(np.int64)].astype(np.int32)
        flag_nonroot = self.index_parent > -1
        self.index_parent[flag_nonroot] = left_index[
            self.index_parent[flag_nonroot].astype(np.int64)].astype(np.int32)
        # root rows never shift (only appended children are removed), but
        # renumber them the same way as index_parent
        self.root_id = left_index[self.root_id.astype(np.int64)].astype(
            np.int32)
        flag_parent = self.node_index != -1
        emptied = (self.tree[self.node_index[flag_parent].astype(np.int64)]
                   < 0).all(axis=-1)
        tmp = flag_parent.copy()
        tmp[flag_parent] = emptied
        self.node_index[tmp] = -1

    def split_and_remove(self, flag_split, flag_remove):
        """The guarded pair: only leaves below max_level split, roots are
        never removed, and the removal runs after the split. Returns the
        effective flags, sized as before the split appended children."""
        flag_remove = flag_remove & self.is_leaf & (~self.is_root)
        flag_split = flag_split & self.is_leaf & (self.depth < self.max_level)
        index_split = np.where(flag_split)[0]
        index_remove = np.where(flag_remove)[0]
        print(f" -> [{self.__class__.__name__}] split: {index_split.shape[0]} "
              f"remove: {index_remove.shape[0]}")
        self.split(index_split)
        self.remove(index_remove)
        return flag_split, flag_remove

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
    root_vis = root_visible[torch.clamp(root_id, min=0).to(torch.int64)]
    return flat_cut_pre(index_parent, node_index, depth, root_vis, radius2d,
                        radius2d_parent, alive_mask, min_resolution_pixel,
                        max_depth)


def flat_cut_pre(index_parent, node_index, depth, root_in_frustum, radius2d,
                 radius2d_parent, alive_mask, min_resolution_pixel,
                 max_depth):
    """`flat_cut` without the gather: root_in_frustum is the (cap,) flag of
    each point's ROOT (the frustum test of the cached root center in the
    flat_slice frame, or root_visible[root_id]), so this is elementwise.
    Without the weight cull it gives a superset of the flat cut; the
    flat_slice frame applies the cull before (w_full) or after the
    compaction."""
    is_root = index_parent == -1
    is_leaf = node_index == -1
    small = radius2d < min_resolution_pixel
    parent_big = radius2d_parent >= min_resolution_pixel
    reach = root_in_frustum & torch.where(is_root, True,
                                          parent_big & (depth <= max_depth))
    return alive_mask & reach & (small | is_leaf | (depth >= max_depth))
