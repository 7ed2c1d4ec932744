"""Synthetic urban-style LoD-tree checkpoints, made from a numpy seed;
counterpart of log_tpu/utils/synth_tree.py (build_scene_device).

The tree structure is strided and deterministic, as in the JAX package:
every 2nd root splits into 4 children and 3 of every 10 depth-1 children
split again, so 600k roots give 3.24M points. Roots cover a 60 x 60 ground
extent in Morton order; children are jittered inside the parent footprint
at 0.55x scale. Unlike the JAX generator, the SH bank is small random noise
rather than zeros, so that view-dependent color is exercised.

`build_checkpoint` returns a LoG checkpoint dict in the key layout of
`LoG.state_dict` (gaussian.*, tree.*, and the counter's radius bounds).
Both packages' `load_state_dict` take it as is, which is how one set of
weights is carried across. The training step clamps each point's scale into
[counter.radius3d_min, counter.radius3d_max] (the init pass sets them in a
real run); here they are 0.5x the point's smallest and 2x its largest axis,
so training starts inside them. `roots_record` gives the roots alone as
activated attributes, the vanilla model's record
(`BaseGaussian.create_from_record`).
"""
from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814
MAX_CHILD = 4


def tree_sizes(n_roots: int) -> tuple[int, int, int]:
    """(n1, n2, n_total) for the strided split structure."""
    n_split1 = n_roots // 2
    n1 = n_split1 * MAX_CHILD
    n_split2 = (n1 // 10) * 3
    n2 = n_split2 * MAX_CHILD
    return n1, n2, n_roots + n1 + n2


def _morton_order(xyz, ext: float):
    q = np.clip(((xyz[:, :2] + ext) / (2 * ext) * 1024).astype(np.int32),
                0, 1023)
    key = np.zeros(xyz.shape[0], np.int64)
    for b in range(10):
        key |= ((q[:, 0] >> b) & 1).astype(np.int64) << (2 * b)
        key |= ((q[:, 1] >> b) & 1).astype(np.int64) << (2 * b + 1)
    return np.argsort(key, kind="stable")


def build_checkpoint(n_roots: int, seed: int = 0, sh_degree: int = 1) -> dict:
    """A LoG checkpoint dict of the synthetic tree (float32 / int32 numpy)."""
    rng = np.random.default_rng(seed)
    n1, n2, n = tree_sizes(n_roots)
    n_split1 = n1 // MAX_CHILD
    n_split2 = n2 // MAX_CHILD
    ext = 30.0
    xyz_r = np.stack([
        rng.uniform(-ext, ext, n_roots),
        rng.uniform(-ext, ext, n_roots),
        rng.uniform(0.0, 2.0, n_roots),
    ], axis=1)
    scal_r = rng.uniform(0.08, 0.25, (n_roots, 1)) * rng.uniform(
        0.6, 1.4, (n_roots, 3)
    )
    order = _morton_order(xyz_r, ext)
    xyz_r, scal_r = xyz_r[order], scal_r[order]

    def children(xyz_p, scal_p, parent_rows):
        off = rng.standard_normal((parent_rows.shape[0], MAX_CHILD, 3))
        c_xyz = xyz_p[parent_rows][:, None] + off * scal_p[parent_rows][:, None] * 0.5
        c_scal = np.broadcast_to(scal_p[parent_rows][:, None] * 0.55,
                                 c_xyz.shape)
        return c_xyz.reshape(-1, 3), c_scal.reshape(-1, 3)

    split1 = np.arange(n_split1, dtype=np.int32) * 2  # every 2nd root
    c1_xyz, c1_scal = children(xyz_r, scal_r, split1)
    m = np.arange(n_split2, dtype=np.int32)
    split2_local = (m // 3) * 10 + (m % 3)  # 3 of every 10 depth-1 rows
    c2_xyz, c2_scal = children(c1_xyz, c1_scal, split2_local)

    f32 = np.float32
    # each attribute goes to float32 as soon as it is drawn (the draws and
    # their order are unchanged), which keeps the host's peak near twice
    # the checkpoint's bytes at 10M points
    xyz = np.concatenate([xyz_r, c1_xyz, c2_xyz]).astype(f32)
    scal = np.concatenate([scal_r, c1_scal, c2_scal])
    del c1_xyz, c2_xyz, c1_scal, c2_scal
    out = {
        "gaussian.xyz": xyz,
        "gaussian.colors": ((rng.uniform(0.0, 1.0, (n, 3)) - 0.5)
                            / SH_C0).astype(f32),
    }
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    out["gaussian.rotation"] = q.astype(f32)
    del q
    opac = rng.uniform(0.3, 0.95, (n, 1))
    out["gaussian.opacity"] = np.log(opac / (1.0 - opac)).astype(f32)
    del opac
    n_sh = (sh_degree + 1) ** 2 - 1
    out["gaussian.shs"] = (0.1 * rng.standard_normal((n, n_sh, 3))).astype(f32)
    out["gaussian.scaling"] = np.log(scal).astype(f32)
    out["counter.radius3d_min"] = (0.5 * scal.min(axis=1)).astype(f32)
    out["counter.radius3d_max"] = (2.0 * scal.max(axis=1)).astype(f32)
    del scal

    split2_rows = split2_local + n_roots
    depth = np.concatenate([np.zeros(n_roots, np.int32),
                            np.ones(n1, np.int32), np.full(n2, 2, np.int32)])
    index_parent = np.concatenate([
        np.full(n_roots, -1, np.int32),
        np.repeat(split1, MAX_CHILD),
        np.repeat(split2_rows, MAX_CHILD),
    ]).astype(np.int32)
    node_index = np.full(n, -1, np.int32)
    node_index[split1] = np.arange(n_split1, dtype=np.int32)
    node_index[split2_rows] = n_split1 + np.arange(n_split2, dtype=np.int32)
    local_index = np.concatenate([
        np.full(n_roots, -1, np.int32),
        np.tile(np.arange(MAX_CHILD, dtype=np.int32), n_split1 + n_split2),
    ])
    tree = (np.arange(n1 + n2, dtype=np.int32) + n_roots).reshape(
        -1, MAX_CHILD
    )
    root_id = np.arange(n, dtype=np.int32)
    root_id[n_roots:n_roots + n1] = index_parent[n_roots:n_roots + n1]
    root_id[n_roots + n1:] = root_id[index_parent[n_roots + n1:]]
    out.update({
        "tree.tree": tree,
        "tree.root_index": np.arange(n_roots, dtype=np.int32),
        "tree.node_index": node_index,
        "tree.index_parent": index_parent,
        "tree.local_index": local_index,
        "tree.depth": depth,
        "tree.root_id": root_id,
    })
    return out


def roots_record(ckpt: dict, n_roots: int) -> dict:
    """The first n_roots points (the roots) of a checkpoint as activated
    attributes: xyz, colors (SH DC as RGB), scaling (exp), opacity
    (sigmoid, (n,)), rotation (normalized) and shs, float32."""
    def rows(key):
        return np.asarray(ckpt[f"gaussian.{key}"][:n_roots], np.float64)

    q = rows("rotation")
    rec = {"xyz": rows("xyz"), "colors": rows("colors") * SH_C0 + 0.5,
           "scaling": np.exp(rows("scaling")),
           "opacity": 1.0 / (1.0 + np.exp(-rows("opacity")[:, 0])),
           "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
           "shs": rows("shs")}
    return {k: v.astype(np.float32) for k, v in rec.items()}
