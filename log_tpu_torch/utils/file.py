"""Point-cloud I/O and the initial scales of a point cloud (host numpy);
counterpart of log_tpu/utils/file.py.

`knn_mean_sq_dist` runs the grid-hash KNN of `native/knn.cpp` (host C++,
built with g++ at first use) and falls back to a scipy cKDTree where the
library does not build; it logs which of the two ran.
"""
from __future__ import annotations

import os

import numpy as np

from .. import native

# the PLY property types the reader knows
_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8",
    "uchar": "u1", "uint8": "u1", "int": "i4", "int32": "i4",
    "short": "i2", "ushort": "u2",
}


def read_ply(filename):
    """xyz (N, 3) float64 and rgb (N, 3) in [0, 1] of a PLY's vertices,
    through plyfile where it is installed."""
    try:
        from plyfile import PlyData
    except ImportError:
        return _read_ply_builtin(filename)
    v = PlyData.read(filename)["vertex"]
    xyz = np.vstack([v["x"], v["y"], v["z"]]).T
    rgb = np.vstack([v["red"], v["green"], v["blue"]]).T / 255.0
    return xyz, rgb


def _read_ply_builtin(filename):
    """A minimal binary or ascii PLY vertex reader (x, y, z and optional
    red, green, blue; gray without colors)."""
    with open(filename, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]
        n_vertex = int(
            next(l for l in header if l.startswith("element vertex")).split()[-1]
        )
        props = []
        in_vertex = False
        for line in header:
            if line.startswith("element"):
                in_vertex = line.startswith("element vertex")
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, typ))
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex)
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            endian = "<" if "little" in fmt else ">"
            dtype = np.dtype([(n, endian + _PLY_TYPES[t]) for n, t in props])
            rec_arr = np.frombuffer(f.read(n_vertex * dtype.itemsize),
                                    dtype=dtype)
            rec = {n: rec_arr[n] for n, _ in props}
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    if "red" in rec:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1) / 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


def write_ply(outname, xyz, colors):
    """A binary little-endian PLY of float xyz and 8-bit colors (colors in
    [0, 1], clipped)."""
    os.makedirs(os.path.dirname(outname) or ".", exist_ok=True)
    colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    n = xyz.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = (colors[:, 0], colors[:, 1],
                                             colors[:, 2])
    with open(outname, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def load_pointcloud(filename, scale3d=1.0, **kwargs):
    """xyz and rgb (float32, rgb in [0, 1]) from a .npz (xyz, rgb in
    0-255) or a .ply, scaled by scale3d and shifted by -offset."""
    if isinstance(filename, dict):
        return np.asarray(filename["xyz"]), np.asarray(filename["colors"])
    if not os.path.exists(filename):
        raise FileNotFoundError(f"file not found: {filename}")
    if filename.endswith(".npz"):
        data = dict(np.load(filename))
        xyz = scale3d * data["xyz"]
        rgb = data["rgb"] / 255.0
    elif filename.endswith(".ply"):
        xyz, rgb = read_ply(filename)
        xyz = scale3d * xyz
    else:
        raise NotImplementedError(filename)
    if "offset" in kwargs:
        xyz = xyz - np.asarray(kwargs["offset"]).reshape(1, 3)
    return xyz.astype(np.float32), rgb.astype(np.float32)


def knn_mean_sq_dist(xyz: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance of each point to its k nearest neighbors: the
    native grid hash, or scipy's cKDTree where it does not build."""
    out = native.knn_mean_sq_dist(xyz, k=k)
    if out is not None:
        print(f"[knn] native grid hash, {xyz.shape[0]} points")
        return out
    print(f"[knn] native path unavailable ({native.build_error()}); "
          f"scipy cKDTree, {xyz.shape[0]} points")
    from scipy.spatial import cKDTree

    d, _ = cKDTree(xyz).query(xyz, k=k + 1, workers=-1)  # first is self
    return np.mean(d[:, 1:] ** 2, axis=1)


def create_from_point(filename, scale3d=1.0, ret_scale=True, **kwargs):
    """(xyz, colors, scales) of a point cloud for GaussianPoint: scales are
    the root of the mean squared distance to the 3 nearest neighbors
    (floored at 1e-7 before the root)."""
    if isinstance(filename, dict):
        xyz = np.asarray(filename["xyz"], np.float32)
        colors = np.asarray(filename["colors"], np.float32)
    else:
        xyz, colors = load_pointcloud(filename, scale3d, **kwargs)
    scales = None
    if ret_scale:
        dist2 = np.maximum(knn_mean_sq_dist(xyz, k=3), 1e-7)
        scales = np.sqrt(dist2).astype(np.float32)
    return xyz, colors, scales
