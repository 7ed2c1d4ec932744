"""The first 5 images of a config's dataset as its loader gives them.

    python -m log_tpu_torch.apps.test_dataset --cfg X.yml [outdir debug] \
        [key value ...]

Writes <outdir>/%06d.jpg (host code only) and returns the paths.
"""
from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from ..utils import image_io
    from ..utils.command import update_global_variable
    from ..utils.config import Config, load_object

    args, cfg = Config.load_args(argv, usage="test dataset")
    cfg = update_global_variable(cfg, cfg)
    dataset = load_object(cfg.dataset.module, cfg.dataset.args)
    outdir = cfg.get("outdir", "debug")
    print(f"dataset: {len(dataset)} items")
    written = []
    for i in range(min(5, len(dataset))):
        item = dataset[i]
        img = item["image"]
        if isinstance(img, np.ndarray):
            out = (img[:, :, ::-1] * 255).astype(np.uint8)
            written.append(image_io.imwrite(
                os.path.join(outdir, f"{i:06d}.jpg"), out))
            print(i, item["imgname"], img.shape)
        else:
            print(i, item["imgname"], "(image not read)")
    return written


if __name__ == "__main__":
    main()
