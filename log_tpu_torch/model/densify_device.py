"""Densification on the model's device: split and remove without the host
round trip; counterpart of log_tpu/model/densify_device.py.

The policy (the threshold flags of both stages) and the rebuild (the
capacity-padded compaction [kept; children] with bisection splits) are
torch ops on the device; the host fetches a few scalars, and for the tree
stage the flag vectors, which the host tree's guards turn into the
effective flags.

The row order is the host Splitter's: kept rows in their original order
(cumsum compaction), then the children in ascending parent order, each
parent's children together; so the two paths give equal arrays from the
same random draws. Scatters that the JAX package drops (its
`mode="drop"`) go to one spare row at index `new_cap`, which is then cut
off. Scalars are reckoned in float32, as the JAX package traces them.
"""
from __future__ import annotations

import numpy as np
import torch

from .counter import init_counter

_F32 = np.float32


def _grad(counter):
    return counter["grad_sum"] / torch.clamp(
        counter["area_sum"].to(torch.float32), min=1.0)


# ------------------------------------------------------------------ policy
def init_stage_flags(params: dict, counter: dict, n_alive: int, rand_u,
                     scale, xyz_scale, init_weight_min, init_radius_min,
                     init_radius_split, min_steps, split_grad_thres,
                     mode: str = "split_by_2d"):
    """The flags of LoG.update_init_stage on the device. rand_u: (2, cap)
    uniforms. Returns (flag_split, flag_remove, reset_create, stats), the
    stats as device scalars."""
    cap = params["opacity"].shape[0]
    dev = params["opacity"].device
    alive = torch.arange(cap, device=dev) < n_alive
    weights_max = counter["weights_max"]
    opacity = torch.sigmoid(params["opacity"][:, 0])
    flag_remove_weight = (weights_max < float(_F32(init_weight_min))) & alive
    flag_nonmax = (weights_max < opacity * 0.1) & alive
    radii_max_max = counter["radii_max_max"]
    small = float((_F32(init_radius_min) * _F32(scale)) ** 2)
    flag_remove_small = (radii_max_max.to(torch.float32) < small) & alive \
        & (rand_u[0] > 0.5)
    flag_remove = flag_remove_small | flag_remove_weight | flag_nonmax
    radii_max = radii_max_max.to(torch.float32)
    flag_activation = (counter["create_steps"] > int(min_steps)) \
        & (radii_max > 0) & alive
    grad = _grad(counter)
    act = flag_activation.to(torch.float32)
    n_act_raw = torch.sum(act)
    n_act = torch.clamp(n_act_raw, min=1.0)
    radii_mean = torch.sum(radii_max * act) / n_act
    radii_var = torch.sum((radii_max - radii_mean) ** 2 * act) / n_act
    radii_std = torch.sqrt(torch.clamp(radii_var, min=0.0))
    has_act = n_act_raw > 0
    radii_mean = torch.where(has_act, radii_mean, 0.0)
    radii_std = torch.where(has_act, radii_std, 0.0)
    reset_create = torch.zeros(cap, dtype=torch.bool, device=dev)
    if mode == "split_by_2d":
        thres_given = _F32(init_radius_split) * _F32(scale)
        if thres_given < 0:
            split_thres = radii_mean + radii_std * 3
        else:
            split_thres = torch.tensor(thres_given, device=dev)
        big = float(_F32(init_radius_min) * _F32(scale) * _F32(8))
        flag_split_grad = (grad > float(_F32(10) * _F32(split_grad_thres))) \
            & (radii_max > big)
        flag_split_radii = radii_max > split_thres ** 2
        flag_split = flag_split_radii | flag_split_grad
        flag_split = flag_activation & flag_split & ~flag_remove
    elif mode == "split_by_3d":
        radius_max3 = torch.max(torch.exp(params["scaling"]), dim=-1).values
        xs = _F32(xyz_scale)
        flag_split = (radius_max3 > float(xs * _F32(0.1))) & alive
        flag_remove2d = flag_activation \
            & (radius_max3 < float(xs * _F32(0.005)))
        flag_rand = rand_u[1] > 0.5
        flag_remove = (flag_remove2d & flag_rand) | flag_remove
        reset_create = flag_remove2d & ~flag_rand
        flag_split = flag_split & ~flag_remove
    else:
        raise ValueError(mode)
    # never prune to (near) nothing: keep the 16 top-weight points; a
    # stable descending sort takes the lower row first among equal
    # weights, as jax.lax.top_k does
    n_kept = torch.sum(~flag_remove & alive)
    w_for_top = torch.where(alive, weights_max, -torch.inf)
    top_idx = torch.sort(w_for_top, descending=True, stable=True).indices[:16]
    guard = torch.zeros(cap, dtype=torch.bool, device=dev)
    guard[top_idx] = True
    flag_remove = torch.where(n_kept < 16, flag_remove & ~guard, flag_remove)
    flag_split = flag_split & ~flag_remove & alive
    stats = {
        "n_remove_weight": torch.sum(flag_remove_weight),
        "n_nonmax": torch.sum(flag_nonmax),
        "n_remove_small": torch.sum(flag_remove_small),
        "n_split": torch.sum(flag_split),
        "n_remove": torch.sum(flag_remove & alive),
    }
    return flag_split, flag_remove & alive, reset_create, stats


def depth_stage_flags(params: dict, counter: dict, tree_dev: dict,
                      n_alive: int, current_depth: int, min_steps_split,
                      split_grad_thres, radius2d_thres, remove_weights_thres,
                      max_split_points, sort_method: str = "radii"):
    """The flags of LoG.update_depth_stage on the device, with the top-K
    split cap. Returns (flag_split, flag_remove, stats)."""
    cap = params["opacity"].shape[0]
    dev = params["opacity"].device
    alive = torch.arange(cap, device=dev) < n_alive
    node_index = tree_dev["node_index"]
    depth = tree_dev["depth"]
    flag_is_parent = (node_index == -1) & (depth < current_depth) & alive
    flag_depth_parent = flag_is_parent \
        & (counter["create_steps"] > int(min_steps_split))
    depth_minus1_sum = torch.sum((depth < current_depth) & alive)
    flag_depth_child = (node_index == -1) & (depth > 0) & alive
    grad = _grad(counter)
    radii_max_max = counter["radii_max_max"].to(torch.float32)
    flag_split = (grad > float(_F32(split_grad_thres))) \
        & (counter["radii_max_max"] > int(radius2d_thres)) & flag_depth_parent
    any_child = torch.sum(flag_depth_child) > 0
    flag_remove = flag_depth_child \
        & (counter["weights_max"] < float(_F32(remove_weights_thres))) \
        & (counter["visible_count"] > 1) & any_child
    flag_split = flag_split & ~flag_remove
    num_max_split = torch.clamp(
        (depth_minus1_sum.to(torch.float32) * 0.05).to(torch.int32),
        max=int(max_split_points))
    if sort_method == "radii":
        vals = radii_max_max
    elif sort_method == "opacity":
        vals = torch.sigmoid(params["opacity"][:, 0])
    else:
        vals = grad
    n_split = torch.sum(flag_split)
    # top-K threshold: the k-th largest candidate (np.partition's)
    cand = torch.where(flag_split, vals, -torch.inf)
    cand_sorted = torch.sort(cand, descending=True).values
    k = torch.clamp(num_max_split, 1, cap).to(torch.int64) - 1
    thres = cand_sorted[k]
    over = (n_split > num_max_split) & (num_max_split > 0)
    flag_split = torch.where(over, flag_split & (vals >= thres), flag_split)
    stats = {"n_split": torch.sum(flag_split),
             "n_remove": torch.sum(flag_remove), "thres": thres, "over": over}
    return flag_split, flag_remove, stats


# ----------------------------------------------------------------- rebuild
def _bisect_once(xyz, scaling, rotation):
    """One split of every row along its longest ACTIVATED scale axis: two
    children at +-0.5 of that axis rotated to world, that axis halved.
    Among equal scales the first axis is the longest (torch.argmax, as
    numpy's and jnp's argmax)."""
    q = rotation / torch.linalg.norm(rotation, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    longest = torch.argmax(scaling, dim=-1)
    one_hot = torch.nn.functional.one_hot(longest, 3).to(scaling.dtype)
    ox, oy, oz = (one_hot * scaling).unbind(-1)
    # world_axis = R @ off_local with R from the quaternion
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    world_axis = torch.stack([r00 * ox + r01 * oy + r02 * oz,
                              r10 * ox + r11 * oy + r12 * oz,
                              r20 * ox + r21 * oy + r22 * oz], dim=-1)
    centers = torch.stack([xyz - 0.5 * world_axis, xyz + 0.5 * world_axis],
                          dim=1)
    new_scaling = scaling * (1.0 - 0.5 * one_hot)
    P = xyz.shape[0]
    return (centers.reshape(P * 2, 3),
            new_scaling.repeat_interleave(2, dim=0),
            rotation.repeat_interleave(2, dim=0))


def split_children_uniform(xyz, scaling_act, rotation, n_child: int):
    """Repeated bisection until 2^k >= n_child. Returns (xyz, activated
    scaling, 2^k)."""
    n = 1
    while n < n_child:
        xyz, scaling_act, rotation = _bisect_once(xyz, scaling_act, rotation)
        n *= 2
    return xyz, scaling_act, n


def _spare(arr, fill):
    """arr with one row of `fill` appended (the drop row)."""
    return torch.cat([arr, torch.full((1,) + arr.shape[1:], fill,
                                      dtype=arr.dtype, device=arr.device)])


def rebuild_split_remove(params: dict, moments: dict, counter: dict,
                         flag_split, flag_remove, n_alive: int, new_cap: int,
                         s_cap: int, n_child: int, remove_split: bool,
                         keys: tuple, scaling_decay, radius3d_max_fill: float):
    """The [kept; children] compaction on the device. Returns (params,
    moments, counter, num_keep, num_children), the last two device
    scalars.

    s_cap: a bucket >= the number of split parents. radius3d_max_fill >= 0
    fills radius3d_max everywhere (init stage); < 0 moves it and gives the
    children scaling_decay x their parent's largest scale (tree stage).
    The counter's other keys start fresh; create_steps moves (0 for the
    children) and the children inherit radius3d_min."""
    cap = params[keys[0]].shape[0]
    dev = params[keys[0]].device
    alive = torch.arange(cap, device=dev) < n_alive
    flag_split = flag_split & alive
    if remove_split:
        flag_remove_eff = (flag_remove | flag_split) & alive
    else:
        flag_remove_eff = flag_remove & alive
    keep = alive & ~flag_remove_eff
    num_keep = torch.sum(keep)
    num_split = torch.sum(flag_split)

    dest_keep = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest_keep = torch.where(keep, dest_keep, new_cap)  # the drop row

    found = torch.nonzero(flag_split)[:, 0]
    if found.numel() > s_cap:
        raise ValueError(f"{found.numel()} split parents exceed s_cap {s_cap}")
    parents = torch.full((s_cap,), cap, dtype=torch.int64, device=dev)
    parents[: found.numel()] = found
    prank = torch.arange(s_cap, device=dev)
    parent_valid = prank < num_split

    def gather(arr, fill):
        return _spare(arr, fill)[parents]

    p_xyz = gather(params["xyz"], 0.0)
    p_scaling_act = torch.exp(gather(params["scaling"], 0.0))
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    p_rot = torch.where(parent_valid[:, None],
                        gather(params["rotation"], 0.0), identity)
    c_xyz, c_scal_act, real_child = split_children_uniform(
        p_xyz, p_scaling_act, p_rot, n_child)
    c_scaling = torch.log(torch.clamp(c_scal_act, min=1e-30))

    child_dest = torch.where(parent_valid, num_keep + prank * real_child,
                             new_cap)
    child_dest_full = (child_dest[:, None]
                       + torch.arange(real_child, device=dev)[None]).reshape(-1)
    child_dest_full = torch.clamp(child_dest_full, max=new_cap)

    def moved(old, fill, child_vals=None):
        out = torch.full((new_cap + 1,) + old.shape[1:], fill,
                         dtype=old.dtype, device=dev)
        out.index_copy_(0, dest_keep, old)
        if child_vals is not None:
            out.index_copy_(0, child_dest_full, child_vals.to(old.dtype))
        return out[:new_cap]

    new_params, new_m1, new_m2 = {}, {}, {}
    for key in keys:
        old = params[key]
        if key == "xyz":
            child_vals = c_xyz
        elif key == "scaling":
            child_vals = c_scaling
        else:
            child_vals = gather(old, 0.0).repeat_interleave(real_child, dim=0)
        new_params[key] = moved(old, 0.0, child_vals)
        if key in moments["exp_avg"]:
            new_m1[key] = moved(moments["exp_avg"][key], 0.0)
            new_m2[key] = moved(moments["exp_avg_sq"][key], 0.0)

    new_counter = {k: torch.from_numpy(v).to(dev)
                   for k, v in init_counter(new_cap).items()}
    new_counter["create_steps"] = moved(counter["create_steps"], 0)
    new_counter["radius3d_min"] = moved(
        counter["radius3d_min"], 1.0,
        gather(counter["radius3d_min"], 1.0).repeat_interleave(real_child))
    if radius3d_max_fill >= 0:
        new_counter["radius3d_max"] = torch.full(
            (new_cap,), float(_F32(radius3d_max_fill)), dtype=torch.float32,
            device=dev)
    else:
        p_rad3 = torch.max(p_scaling_act, dim=-1).values
        new_counter["radius3d_max"] = moved(
            counter["radius3d_max"], 1.0,
            (float(_F32(scaling_decay)) * p_rad3).repeat_interleave(
                real_child))
    return (new_params, {"exp_avg": new_m1, "exp_avg_sq": new_m2},
            new_counter, num_keep, num_split * real_child)
