"""Ground alignment from the camera centers of a COLMAP model: fit a plane
to the centers and rotate the world so that its normal (towards the cameras'
mean viewing direction) is +z; cameras.bin is copied, images.bin and
points3D.bin rewritten.

    python -m log_tpu_torch.apps.calibration.align_with_cam \
        --colmap_path sparse/0 --target_path sparse-align
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ...utils.colmap_utils import (
    qvec2rotmat,
    read_images_binary,
    read_points3d_binary,
    rotmat2qvec,
    write_images_binary,
    write_points3d_binary,
)


def plane_normal(points):
    centroid = points.mean(axis=0)
    _, _, vh = np.linalg.svd(points - centroid)
    return vh[-1]


def rotation_between(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-12:
        return np.eye(3)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + k + k @ k * ((1 - c) / (s**2))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Align world with cameras")
    parser.add_argument("--colmap_path", type=str, required=True)
    parser.add_argument("--target_path", type=str, required=True)
    args = parser.parse_args(argv)

    images = read_images_binary(f"{args.colmap_path}/images.bin")
    pt3d = read_points3d_binary(f"{args.colmap_path}/points3D.bin")
    print(f">> Loaded {len(images)} images, {len(pt3d)} points3D")

    towards = np.mean(
        [qvec2rotmat(v.qvec)[:, 2] for v in images.values()], axis=0
    )
    towards /= np.linalg.norm(towards)
    centers = []
    for v in images.values():
        R = qvec2rotmat(v.qvec)
        centers.append(-R.T @ v.tvec)
    centers = np.asarray(centers)
    normal = plane_normal(centers)
    if float(np.dot(normal, towards)) < 0:
        normal = -normal
    rotation = rotation_between(normal, np.array([0.0, 0.0, 1.0]))

    new_images = {}
    for k, v in images.items():
        R = qvec2rotmat(v.qvec)
        center = -R.T @ v.tvec
        R_new = R @ rotation.T
        center_new = rotation @ center
        new_images[k] = v._replace(
            qvec=rotmat2qvec(R_new), tvec=-R_new @ center_new
        )
    new_pts = {
        k: v._replace(xyz=rotation @ v.xyz) for k, v in pt3d.items()
    }
    os.makedirs(args.target_path, exist_ok=True)
    shutil.copy(
        f"{args.colmap_path}/cameras.bin", f"{args.target_path}/cameras.bin"
    )
    write_images_binary(new_images, f"{args.target_path}/images.bin")
    write_points3d_binary(new_pts, f"{args.target_path}/points3D.bin")
    print(f">> wrote aligned model to {args.target_path}")


if __name__ == "__main__":
    main()
