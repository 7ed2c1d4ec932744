"""The raw point cloud of a config (cfg.PLYNAME) rendered as fixed-radius
Gaussians (a BaseGaussian, SH 0, opacity 0.9, radius cfg.point_radius or
0.01) through NaiveRendererAndLoss.vis from the first 5 views of its
dataset, beside the image where it was read: a check of the camera
conventions end to end.

    python -m log_tpu_torch.apps.test_pointcloud --cfg X.yml \
        [--device cuda|cpu] [outdir debug] [key value ...]

Writes <outdir>/pointcloud_%06d.jpg and returns the paths.
"""
from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from ..model.base_gaussian import BaseGaussian
    from ..render.renderer import NaiveRendererAndLoss
    from ..utils import image_io
    from ..utils.command import update_global_variable
    from ..utils.config import Config, load_object
    from ..utils.file import load_pointcloud
    from .train import _batchify, resolve_device

    args, cfg = Config.load_args(argv, usage="test pointcloud")
    cfg = update_global_variable(cfg, cfg)
    device = resolve_device(args.device)
    dataset = load_object(cfg.dataset.module, cfg.dataset.args)
    xyz, rgb = load_pointcloud(cfg.PLYNAME, scale3d=cfg.get("scale3d", 1.0))
    radius = cfg.get("point_radius", 0.01)
    n = xyz.shape[0]
    model = BaseGaussian.create_from_record(
        {"xyz": xyz, "colors": rgb,
         "scaling": np.full((n, 3), radius, np.float32),
         "opacity": np.full((n,), 0.9, np.float32)},
        sh_degree=0, device=device)
    renderer = NaiveRendererAndLoss(split="demo", background=(1.0, 1.0, 1.0),
                                    device=device)
    outdir = cfg.get("outdir", "debug")
    written = []
    for i in range(min(5, len(dataset))):
        item = dataset[i]
        out = renderer.vis(_batchify(item), model)
        vis = renderer.tensor_to_bgr(out["render"][0])
        if isinstance(item.get("image"), np.ndarray):
            gt = (item["image"][:, :, ::-1] * 255).astype(np.uint8)
            vis = np.hstack([vis, gt])
        written.append(image_io.imwrite(
            os.path.join(outdir, f"pointcloud_{i:06d}.jpg"), vis))
        print("wrote", written[-1])
    return written


if __name__ == "__main__":
    main()
