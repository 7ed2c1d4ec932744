"""Synthetic urban-style LoD-tree scenes; counterpart of
log_tpu/utils/synth_tree.py.

Two generators share one tree structure. `build_checkpoint` draws on the
host from a numpy seed and returns a LoG checkpoint; `build_scene` (the
counterpart of `build_scene_device`) draws on the device the JAX
generator's own random numbers (`utils/jax_random.py`) from a key, with
zero SH, so that a multi-M-point scene needs no host build and is the
scene that the JAX scripts draw from the same key. `pad_scene` (the
counterpart of `padded_model_device`) pads either generator's arrays to a
capacity in the "level" or "root_major" row layout and adds the flat cut's
caches: its output is the (params, tree arrays, is_leaf_opt) that
`fused_prepare_render`, `fused_root_cull` and `build_block_cache` take.
`checkpoint_scene` gives a checkpoint's points as `pad_scene`'s input.

The tree structure is strided and deterministic, as in the JAX package:
every 2nd root splits into 4 children and 3 of every 10 depth-1 children
split again, so 600k roots give 3.24M points. Roots cover a 60 x 60 ground
extent in Morton order; children are jittered inside the parent footprint
at 0.55x scale. Unlike the JAX generator, `build_checkpoint`'s SH bank is
small random noise rather than zeros, so that view-dependent color is
exercised.

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
import torch

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


def _morton2d_key(x, y, ext: float):
    """The 10-bit-per-axis 2-D Morton key of the JAX generator (int64)."""
    def q(v):
        return torch.clamp(((v + ext) / (2 * ext) * 1024).to(torch.int32),
                           0, 1023).to(torch.int64)

    qx, qy = q(x), q(y)
    key = torch.zeros_like(qx)
    for b in range(10):
        key |= (((qx >> b) & 1) << (2 * b)) | (((qy >> b) & 1) << (2 * b + 1))
    return key


def scene_tree(n_roots: int, device) -> dict:
    """The strided tree arrays (node_index, index_parent, depth, root_id;
    int32, unpadded), as build_scene_device lays them out."""
    n1, n2, n = tree_sizes(n_roots)
    n_split1, n_split2 = n1 // MAX_CHILD, n2 // MAX_CHILD
    i32 = dict(dtype=torch.int32, device=device)
    split1 = torch.arange(n_split1, **i32) * 2
    m = torch.arange(n_split2, **i32)
    split2 = (m // 3) * 10 + (m % 3) + n_roots
    index_parent = torch.cat([torch.full((n_roots,), -1, **i32),
                              split1.repeat_interleave(MAX_CHILD),
                              split2.repeat_interleave(MAX_CHILD)])
    node_index = torch.full((n,), -1, **i32)
    node_index[split1.long()] = torch.arange(n_split1, **i32)
    node_index[split2.long()] = n_split1 + torch.arange(n_split2, **i32)
    depth = torch.cat([torch.zeros(n_roots, **i32), torch.ones(n1, **i32),
                       torch.full((n2,), 2, **i32)])
    root_id = torch.arange(n, **i32)
    root_id[n_roots:n_roots + n1] = index_parent[n_roots:n_roots + n1]
    root_id[n_roots + n1:] = root_id[index_parent[n_roots + n1:].long()]
    return {"node_index": node_index, "index_parent": index_parent,
            "depth": depth, "root_id": root_id}


def build_scene(n_roots: int, key, device="cuda"):
    """The synthetic scene of build_scene_device(key, n_roots), drawn on
    `device` with the JAX package's random numbers (utils/jax_random.py;
    `key` is a jax_random key, e.g. `prng_key(0)` for bench.py's scene):
    (params, tree), every array n_total rows long, unpadded. params: xyz,
    colors (SH DC), scaling (log), opacity (logit), rotation, shs (zeros,
    (n, 3, 3)); tree: scene_tree's arrays. The uniform draws equal JAX's
    bit for bit and the normal draws within a few ulps (jax_random's
    normal); the roots are Morton-ordered over the 60 x 60 extent."""
    from . import jax_random as jr

    dev = torch.device(device)
    n1, n2, n = tree_sizes(n_roots)
    ext = 30.0
    ks = jr.split(key, 10)

    def uniform(k, shape, lo=0.0, hi=1.0):
        return jr.uniform(ks[k], shape, lo, hi, dev)

    xyz_r = torch.stack([uniform(0, (n_roots,), -ext, ext),
                         uniform(1, (n_roots,), -ext, ext),
                         uniform(2, (n_roots,), 0.0, 2.0)], dim=1)
    scal_r = uniform(3, (n_roots, 1), 0.08, 0.25) * uniform(4, (n_roots, 3),
                                                            0.6, 1.4)
    order = torch.sort(_morton2d_key(xyz_r[:, 0], xyz_r[:, 1], ext),
                       stable=True).indices
    xyz_r, scal_r = xyz_r[order], scal_r[order]
    tree = scene_tree(n_roots, dev)
    ip = tree["index_parent"].long()

    def children(xyz_p, scal_p, parent_rows, k):
        off = jr.normal(ks[k], (parent_rows.shape[0], MAX_CHILD, 3), dev)
        p_xyz, p_scal = xyz_p[parent_rows], scal_p[parent_rows]
        c_xyz = p_xyz[:, None] + off * p_scal[:, None] * 0.5
        c_scal = (p_scal[:, None] * 0.55).expand_as(c_xyz)
        return c_xyz.reshape(-1, 3), c_scal.reshape(-1, 3)

    c1_xyz, c1_scal = children(xyz_r, scal_r, ip[n_roots:n_roots + n1:4], 5)
    c2_xyz, c2_scal = children(c1_xyz, c1_scal,
                               ip[n_roots + n1::4] - n_roots, 6)
    xyz = torch.cat([xyz_r, c1_xyz, c2_xyz])
    scal = torch.cat([scal_r, c1_scal, c2_scal])
    colors = uniform(7, (n, 3))
    q = jr.normal(ks[8], (n, 4), dev)
    opac = uniform(9, (n, 1), 0.3, 0.95)
    params = {
        "xyz": xyz,
        # XLA divides by the constant as a multiply by its float32
        # reciprocal
        "colors": (colors - 0.5) * float(1 / np.float32(SH_C0)),
        "scaling": torch.log(scal),
        "opacity": torch.log(opac / (1.0 - opac)),
        "rotation": q / torch.linalg.norm(q, dim=1, keepdim=True),
        "shs": torch.zeros((n, 3, 3), dtype=torch.float32, device=dev),
    }
    return params, tree


def checkpoint_scene(ckpt: dict, device=None):
    """build_checkpoint's points as pad_scene's (params, tree) input, on the
    card unless the caller passes device="cpu"."""
    device = torch.device("cuda" if device is None else device)

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    params = {k: t(ckpt[f"gaussian.{k}"])
              for k in ("xyz", "colors", "scaling", "opacity", "rotation",
                        "shs")}
    tree = {k: t(ckpt[f"tree.{k}"]).to(torch.int32)
            for k in ("node_index", "index_parent", "depth", "root_id")}
    return params, tree


@torch.no_grad()
def pad_scene(params: dict, tree: dict, cap: int, layout: str = "level"):
    """The scene padded to cap rows with the flat cut's caches:
    padded_model_device's contract on given arrays (numpy or torch; the
    roots must be the row prefix). Returns (params, tree_dev, is_leaf_opt)
    on the arrays' device.

    layout="level" keeps the rows as given; "root_major" keeps the roots
    and regroups the tail rows (depth >= 1) contiguously per root, in root
    order (parents before children), and adds "cull_seg_starts" ((cap,)
    int32: the first tail row of root rank j, n for empty and padding
    ranks), which makes fused_root_cull's expansion a scatter-max +
    cummax. tree_dev also carries parent_xyz / parent_scaling /
    parent_rotation (a root reads itself) and root_xyz."""
    def t(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))

    params = {k: t(v) for k, v in params.items()}
    tree = {k: t(v).to(torch.int32) for k, v in tree.items()}
    n = tree["index_parent"].shape[0]
    dev = tree["index_parent"].device
    if cap < n:
        raise ValueError(f"cap {cap} < scene size {n}")
    n_roots = int((tree["index_parent"] == -1).sum())
    seg_starts = None
    if layout == "root_major":
        n_tail = n - n_roots
        rid_tail = tree["root_id"][n_roots:]
        perm_t = torch.sort(rid_tail, stable=True).indices
        inv_t = torch.empty_like(perm_t)
        inv_t[perm_t] = torch.arange(n_tail, device=dev)

        def reord(a):
            return torch.cat([a[:n_roots], a[n_roots:][perm_t]])

        def remap_ref(v):
            # row ids -> new row ids (roots do not move; -1 stays)
            vt = inv_t[torch.clamp(v.long() - n_roots, 0,
                                   max(n_tail - 1, 0))] + n_roots
            return torch.where(v >= n_roots, vt.to(v.dtype), v)

        params = {k: reord(v) for k, v in params.items()}
        tree = {"node_index": reord(tree["node_index"]),
                "index_parent": remap_ref(reord(tree["index_parent"])),
                "depth": reord(tree["depth"]),
                "root_id": reord(tree["root_id"])}
        seg_starts = (n_roots + torch.searchsorted(
            rid_tail[perm_t].contiguous(),
            torch.arange(cap, dtype=torch.int32, device=dev), side="left",
        )).to(torch.int32)
    elif layout != "level":
        raise ValueError(f"unknown layout {layout!r}")

    def pad(a, fill=0):
        out = torch.full((cap,) + a.shape[1:], fill, dtype=a.dtype,
                         device=dev)
        out[:n] = a
        return out

    params = {k: pad(v) for k, v in params.items()}
    tree_dev = {"node_index": pad(tree["node_index"], -1),
                "index_parent": pad(tree["index_parent"], -1),
                "depth": pad(tree["depth"]), "root_id": pad(tree["root_id"])}
    ip = tree_dev["index_parent"].long()
    parent = torch.where(ip >= 0, ip, torch.arange(cap, device=dev))
    for key in ("xyz", "scaling", "rotation"):
        tree_dev[f"parent_{key}"] = params[key][parent]
    tree_dev["root_xyz"] = params["xyz"][
        torch.clamp(tree_dev["root_id"].long(), 0, cap - 1)]
    if seg_starts is not None:
        tree_dev["cull_seg_starts"] = seg_starts
    is_leaf_opt = (tree_dev["node_index"] == -1) & (tree_dev["depth"] > 0)
    return params, tree_dev, is_leaf_opt
