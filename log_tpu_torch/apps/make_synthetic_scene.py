"""Write a synthetic scene on disk in the layout the scene dataset reads
(images/cam/%04d<ext>, intri.yml / extri.yml, sparse/0/sparse.npz), with
the images rendered by the port's oracle on the chosen device.

    python -m log_tpu_torch.apps.make_synthetic_scene [outdir] [n_gaussians]
        [n_views] [H] [W] [ext] [--device cuda|cpu]

The positional arguments are the JAX package's apps/make_synthetic_scene.py
ones plus the image extension (default .jpg; .png needs no JPEG encoder).
The same arguments give the same cameras, point cloud and 8-bit images.
"""
from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("outdir", nargs="?", default="data/synthetic")
    parser.add_argument("n_gaussians", nargs="?", type=int, default=300)
    parser.add_argument("n_views", nargs="?", type=int, default=16)
    parser.add_argument("H", nargs="?", type=int, default=240)
    parser.add_argument("W", nargs="?", type=int, default=320)
    parser.add_argument("ext", nargs="?", default=".jpg")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..dataset.camera_utils import write_camera
    from ..dataset.synthetic import SyntheticDataset
    from ..utils import image_io
    from .train import resolve_device

    device = resolve_device(args.device)
    H, W = args.H, args.W
    ds = SyntheticDataset(n_gaussians=args.n_gaussians, n_views=args.n_views,
                          H=H, W=W, seed=0, device=device)
    os.makedirs(join(args.outdir, "images", "cam"), exist_ok=True)
    cameras = {}
    for i, cam in enumerate(ds.cameras):
        name = f"cam/{i:04d}"
        img = (np.clip(ds.images[i], 0, 1)[:, :, ::-1] * 255).astype(np.uint8)
        image_io.imwrite(join(args.outdir, "images", name + args.ext), img)
        cameras[name] = {"K": cam["K"], "R": cam["R"],
                         "T": cam["T"].reshape(3, 1), "H": H, "W": W,
                         "dist": np.zeros((1, 5))}
    write_camera(cameras, args.outdir)
    os.makedirs(join(args.outdir, "sparse", "0"), exist_ok=True)
    pc = ds.noisy_pointcloud()
    np.savez(join(args.outdir, "sparse", "0", "sparse.npz"), xyz=pc["xyz"],
             rgb=(pc["colors"] * 255).astype(np.uint8))
    print(f"wrote synthetic scene to {args.outdir}: {args.n_views} views "
          f"{H}x{W}, {args.n_gaussians} gaussians")
    return ds


if __name__ == "__main__":
    main()
