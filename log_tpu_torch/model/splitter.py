"""Densify and prune on the host: numpy rebuilds of the point arrays;
counterpart of log_tpu/model/splitter.py.

Shape-changing by nature, so it runs at densification cadence on
exact-size host arrays. 'uniform' bisects along the longest scaled axis
(offset +-0.5 s_max along the rotated axis, that axis halved) until
2^k >= N; 'sample' draws N Gaussian samples per parent (from the caller's
numpy Generator) with scaling / sqrt(N). The new row order is [kept;
children], each parent's children together in parent order; optimizer
moments are zero for the children.
"""
from __future__ import annotations

import math

import numpy as np


def np_quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float32)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _bisect_longest_axis(xyz, scaling, rotation, scaling_factor=0.5):
    """One binary split along the longest scaled axis
    (LoG/model/splitter.py:5-31). Returns (2P, 3) centers, (2P, 3) scalings."""
    P = xyz.shape[0]
    R = np_quat_to_rotmat(rotation)
    longest = scaling.argmax(axis=-1)
    axis_unit = np.zeros_like(scaling)
    axis_unit[np.arange(P), longest] = 1.0
    # offsets ±0.5 * s_max along rotated longest axis
    offsets = axis_unit * scaling  # (P, 3) local offset magnitude
    world_axis = np.einsum("pij,pj->pi", R, offsets)
    centers = np.stack(
        [xyz - 0.5 * world_axis, xyz + 0.5 * world_axis], axis=1
    )  # (P, 2, 3)
    new_scaling = scaling.copy()
    new_scaling[np.arange(P), longest] *= scaling_factor
    new_scaling = np.repeat(new_scaling[:, None], 2, axis=1)
    return centers.reshape(-1, 3), new_scaling.reshape(-1, 3)


def split_by_uniform(xyz, scaling, rotation, N: int, scaling_factor=0.5):
    """Repeated bisection until 2^k >= N (LoG/model/splitter.py:95-130).

    xyz: (P, 3); scaling: (P, 3) ACTIVATED; rotation: (P, 4).
    Returns (xyz_children (P*2^k, 3), scaling_children ACTIVATED,
    children_per_parent)."""
    for log2 in range(1, 4):
        xyz, scaling = _bisect_longest_axis(xyz, scaling, rotation, scaling_factor)
        rotation = np.repeat(rotation, 2, axis=0)
        if 2**log2 >= N:
            break
    return xyz, scaling, 2**log2


def split_by_sample(xyz, scaling, rotation, N: int, scaling_factor=1.0, rng=None):
    """Gaussian-sampled children, scaling / sqrt(N)
    (LoG/model/splitter.py:59-93)."""
    rng = rng or np.random.default_rng()
    P = xyz.shape[0]
    stds = np.repeat(scaling[:, None], N, axis=1)  # (P, N, 3)
    samples = rng.normal(0.0, stds / scaling_factor).astype(np.float32)
    R = np_quat_to_rotmat(rotation)
    centers = np.einsum("pij,pnj->pni", R, samples) + xyz[:, None]
    new_scaling = np.repeat((scaling / math.sqrt(N))[:, None], N, axis=1)
    return centers.reshape(-1, 3), new_scaling.reshape(-1, 3), N


class Splitter:
    """Mirrors LoG/model/splitter.py:132-220 over host arrays."""

    def __init__(self, N=4, scaling_factor=0.7, split_method="uniform"):
        self.N = N
        self.split_method = split_method
        self.scaling_factor = scaling_factor

    def make_children(self, arrays: dict, activation, flag_split, rng=None):
        """Child attribute dict for parents marked in flag_split.

        `arrays` holds param-space host arrays; scaling is de/re-activated
        around the geometric split like the reference."""
        index = np.where(flag_split)[0]
        if index.size == 0:
            return {}, 0
        xyz = arrays["xyz"][index]
        act = getattr(activation, "np_scaling_activation", np.exp)
        scaling_act = act(arrays["scaling"][index])
        rotation = arrays["rotation"][index]
        if self.split_method == "uniform":
            c_xyz, c_scal, n_child = split_by_uniform(
                xyz, scaling_act, rotation, self.N, scaling_factor=0.5
            )
        elif self.split_method == "sample":
            c_xyz, c_scal, n_child = split_by_sample(
                xyz, scaling_act, rotation, self.N, rng=rng
            )
        else:
            raise ValueError(self.split_method)
        inv = getattr(activation, "np_scaling_inverse_activation", np.log)
        c_scal_param = inv(c_scal)
        print(
            f"[Splitter] split : {index.size} -> {c_xyz.shape[0]} | radius "
            f"{scaling_act.mean():.4f} -> {c_scal.mean():.4f}"
        )
        return {"xyz": c_xyz.astype(np.float32),
                "scaling": c_scal_param.astype(np.float32)}, n_child

    def split_and_remove(
        self,
        arrays: dict,
        activation,
        flag_split,
        flag_remove,
        remove_split: bool = True,
        rng=None,
    ):
        """Rebuild every attr as [kept; children]. Returns (new_arrays,
        num_keep, num_children)."""
        print(
            f"[{self.__class__.__name__}] split method {self.split_method}, "
            f"remove {flag_split.shape[0]} +{int(flag_split.sum())}x{self.N} "
            f"-{int(flag_remove.sum())}"
        )
        children, n_child = self.make_children(arrays, activation, flag_split, rng)
        if remove_split:
            flag_remove = flag_remove | flag_split
        keep = ~flag_remove
        num_keep = int(keep.sum())
        num_split = int(flag_split.sum())
        new_arrays = {}
        for key, old in arrays.items():
            parts = [old[keep]]
            if num_split > 0:
                if key in children:
                    parts.append(children[key])
                else:
                    parts.append(np.repeat(old[flag_split], n_child, axis=0))
            new_arrays[key] = np.concatenate(parts, axis=0)
        return new_arrays, num_keep, num_split * n_child

    def split_and_remove_moments(
        self, moments: dict, flag_split, flag_remove, remove_split: bool = True
    ):
        """[kept; zeros] for optimizer state (LoG/model/splitter.py:183-197)."""
        if remove_split:
            flag_remove = flag_remove | flag_split
        keep = ~flag_remove
        n_child = int(flag_split.sum()) * self.N
        new_moments = {}
        for mk, d in moments.items():
            new_moments[mk] = {}
            for key, val in d.items():
                zeros = np.zeros((n_child,) + val.shape[1:], val.dtype)
                new_moments[mk][key] = np.concatenate([val[keep], zeros], axis=0)
        return new_moments

    def split_and_remove_other(
        self, arrays: dict, keys, flag_split, flag_remove, remove_split: bool = True
    ):
        """Counter-array rebuild: zeros for children except radius3d_min which
        children inherit (LoG/model/splitter.py:207-220)."""
        if remove_split:
            flag_remove_eff = flag_remove | flag_split
        else:
            flag_remove_eff = flag_remove
        keep = ~flag_remove_eff
        n_child = int(flag_split.sum()) * self.N
        out = dict(arrays)
        for key in keys:
            old = arrays[key]
            new_val = np.zeros((int(keep.sum()) + n_child,), old.dtype)
            new_val[: int(keep.sum())] = old[keep]
            if key == "radius3d_min" and n_child > 0:
                new_val[int(keep.sum()):] = np.repeat(old[flag_split], self.N)
            out[key] = new_val
        return out
