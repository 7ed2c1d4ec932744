"""COLMAP model -> LoG camera files: points3D seen by at least min_views
images, K and dist per camera model, optional PCA axis alignment; writes
sparse.npz (xyz, rgb) and intri.yml / extri.yml into the model's folder.

    python -m log_tpu_torch.apps.calibration.read_colmap <path> \
        [--ext .bin|.txt] [--min_views 3] [--pca]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ...dataset.camera_utils import write_camera
from ...utils.colmap_utils import qvec2rotmat, read_model


def camera_to_K_dist(cam):
    p = cam.params
    if cam.model == "SIMPLE_RADIAL":
        f, cx, cy, k = p
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        dist = np.array([[k, 0, 0, 0, 0]], np.float64)
    elif cam.model == "SIMPLE_PINHOLE":
        f, cx, cy = p
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        dist = np.zeros((1, 5))
    elif cam.model == "PINHOLE":
        fx, fy, cx, cy = p
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        dist = np.zeros((1, 5))
    else:  # OPENCV-family: fx fy cx cy k1 k2 p1 p2 ...
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
        dist = np.array([[p[4], p[5], p[6], p[7], 0.0]])
    return K, dist


def pca_align(xyz, cameras):
    """Rotate world so the principal axes align with xyz axes; cameras follow."""
    mean = np.mean(xyz, axis=0)
    cov = np.cov(xyz - mean[None], rowvar=False)
    eigenvalues, eigenvectors = np.linalg.eig(cov)
    eigenvectors = eigenvectors[:, np.argsort(-eigenvalues)]
    eigenvectors[:, 1] *= -1
    eigenvectors[:, 2] = np.cross(eigenvectors[:, 0], eigenvectors[:, 1])
    R = eigenvectors.T
    T = -mean[None] @ R.T
    xyz_new = xyz @ R.T + T
    for camera in cameras.values():
        camera["R"] = camera["R"] @ R.T
        camera["T"] = camera["T"] - camera["R"] @ T.reshape(3, 1)
    return xyz_new, cameras


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("--ext", type=str, default=".bin")
    parser.add_argument("--min_views", type=int, default=3)
    parser.add_argument("--pca", action="store_true")
    args = parser.parse_args(argv)

    cameras, images, points3d = read_model(path=args.path, ext=args.ext)
    points3d = {
        k: v for k, v in points3d.items()
        if v.image_ids.shape[0] >= args.min_views
    }
    print(
        f"[Read Colmap] kept {len(points3d)} points3D (min_views="
        f"{args.min_views})"
    )
    cameras_out = {}
    for key, cam in cameras.items():
        K, dist = camera_to_K_dist(cam)
        cameras_out[key] = {
            "K": K, "dist": dist, "H": cam.height, "W": cam.width,
        }
    cameras_new = {}
    for val in images.values():
        cam = dict(cameras_out[val.camera_id])
        cam["R"] = qvec2rotmat(val.qvec)
        cam["T"] = val.tvec.reshape(3, 1)
        cameras_new[val.name.split(".")[0]] = cam
    cameras_new = {k: cameras_new[k] for k in sorted(cameras_new)}
    print(f"num_cameras: {len(cameras)} num_images: {len(images)}")
    if points3d:
        keys = list(points3d.keys())
        xyz = np.stack([points3d[k].xyz for k in keys])
        rgb = np.stack([points3d[k].rgb for k in keys])
        if args.pca:
            xyz, cameras_new = pca_align(xyz, cameras_new)
        np.savez(os.path.join(args.path, "sparse.npz"), xyz=xyz, rgb=rgb)
        print(f"wrote {os.path.join(args.path, 'sparse.npz')}: {xyz.shape}")
    write_camera(cameras_new, args.path)
    print(f"wrote intri.yml/extri.yml to {args.path}")


if __name__ == "__main__":
    main()
