"""Umeyama similarity (scale, R, t) from the COLMAP camera centers to their
EXIF GPS positions (gps.npy of read_gps_info, in units of 100 m), applied to
the whole model.

    python -m log_tpu_torch.apps.calibration.align_with_gps \
        --gps_path gps.npy --colmap_path sparse/0 --output_colmap_path out
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


def umeyama_similarity(source, target):
    """scale, R, t minimizing ||target - (s R source + t)||."""
    cs = source.mean(axis=0)
    ct = target.mean(axis=0)
    sc = source - cs
    tc = target - ct
    H = sc.T @ tc
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    scale = np.sum(S) / np.sum(sc**2)
    t = ct.T - (R * scale) @ cs.T
    return scale, R, t


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gps_path", default="./gps.npy")
    parser.add_argument("--colmap_path", default="./sparse/0/")
    parser.add_argument("--output_colmap_path", default="./sparse-align/")
    args = parser.parse_args(argv)

    os.makedirs(args.output_colmap_path, exist_ok=True)
    shutil.copy(
        os.path.join(args.colmap_path, "cameras.bin"),
        os.path.join(args.output_colmap_path, "cameras.bin"),
    )
    gps_dict = np.load(args.gps_path, allow_pickle=True).tolist()
    images = read_images_binary(os.path.join(args.colmap_path, "images.bin"))
    pt3d = read_points3d_binary(os.path.join(args.colmap_path, "points3D.bin"))

    cam_centers, gps_pts = [], []
    for v in images.values():
        if v.name not in gps_dict:
            continue
        R = qvec2rotmat(v.qvec)
        cam_centers.append(-R.T @ v.tvec)
        gps_pts.append(np.asarray(gps_dict[v.name]) / 100.0)  # 100 m unit
    cam_centers = np.asarray(cam_centers)
    gps_pts = np.asarray(gps_pts)
    print(f">> matched {len(cam_centers)} cameras with GPS")
    scale, R, t = umeyama_similarity(cam_centers, gps_pts)
    print(f">> similarity: scale={scale:.6f}\nR=\n{R}\nt={t}")

    new_images = {}
    for k, v in images.items():
        Rc = qvec2rotmat(v.qvec)
        center = -Rc.T @ v.tvec
        center_new = scale * (R @ center) + t
        R_new = Rc @ R.T
        new_images[k] = v._replace(
            qvec=rotmat2qvec(R_new), tvec=-R_new @ center_new
        )
    new_pts = {
        k: v._replace(xyz=scale * (R @ v.xyz) + t) for k, v in pt3d.items()
    }
    write_images_binary(
        new_images, os.path.join(args.output_colmap_path, "images.bin")
    )
    write_points3d_binary(
        new_pts, os.path.join(args.output_colmap_path, "points3D.bin")
    )
    print(f">> wrote aligned model to {args.output_colmap_path}")


if __name__ == "__main__":
    main()
