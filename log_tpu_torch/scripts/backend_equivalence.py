"""Backend equivalence: one config trained end to end on the tiled
backend and on the oracle, their validation PSNR side by side;
counterpart of scripts/run_backend_equivalence.sh.

The scene is made by the port's `apps.make_synthetic_scene` (config/
synthetic's scene for config/synthetic, the JAX runs' 20,000 Gaussians
over 36 views at 256x320 for config/synthetic_conv; .png), then the
config trains through `log_tpu_torch.apps.train` once per backend
(LOG_TPU_BACKEND=tiled, then reference) under <out>/<backend>, and
`apps.final_val` validates each run's last stage checkpoint. Reports each
run's validation PSNR series (the "val/psnr" records of its scalars.jsonl),
its point count after each densify ("train/num_points"; the two backends
draw the same random numbers, so where these part, a densify decided
differently on the two backends' arithmetic), its final-val PSNR and SSIM
and its wall times.

    python -m log_tpu_torch.scripts.backend_equivalence
        [--cfg config/synthetic/train.yml] [--out output/equiv]
        [--device cuda|cpu] [key value ...]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

from . import _common as C

BACKENDS = ("tiled", "reference")
# make_synthetic_scene's n_gaussians, n_views, H, W for each config's scene
SCENES = {"config/synthetic/train.yml": ["200", "16", "120", "160"],
          "config/synthetic_conv/train.yml": ["20000", "36", "256", "320"]}
STAGE_CKPTS = ("model_tree_full.pth", "model_tree.pth", "model_init.pth")


def val_series(exp: str, key: str = "val/psnr") -> list:
    """[(step, value)] of the `key` records the training run logged (its
    scalars.jsonl sits in the run's code snapshot under exp)."""
    series = []
    for path in sorted(glob.glob(os.path.join(exp, "code_backup_*",
                                              "scalars.jsonl"))):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("key") == key:
                    series.append((r["step"], r["val"]))
    return series


def last_checkpoint(exp: str) -> str:
    for name in STAGE_CKPTS:
        path = os.path.join(exp, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no stage checkpoint under {exp}")


def run(cfg: str = "config/synthetic/train.yml", out: str = "output/equiv",
        opts=(), scene=None, backends=BACKENDS, device=None) -> dict:
    """Each backend's run of cfg on a scene made under <out>/scene (scene:
    make_synthetic_scene's n_gaussians, n_views, H, W; SCENES[cfg] by
    default). opts: extra key value overrides for every run."""
    from ..apps import final_val, make_synthetic_scene, train

    dev = C.resolve_device(device)
    dev_args = ["--device", dev.type]
    scene_dir = os.path.join(out, "scene")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_scene.main([scene_dir, *(scene or SCENES[cfg]), ".png",
                               *dev_args])
    res = {"metric": "backend_equivalence", "card": C.card_line(dev),
           "cfg": cfg, "scene": list(scene or SCENES[cfg]),
           "scene_s": time.perf_counter() - t0, "runs": {}}
    saved = os.environ.get("LOG_TPU_BACKEND")
    try:
        for backend in backends:
            exp = os.path.join(out, backend, "log")
            run_opts = ["root", scene_dir, "PLYNAME",
                        os.path.join(scene_dir, "sparse/0/sparse.npz"),
                        "exp", exp, "dataset.args.ext", ".png",
                        "val_dataset.args.ext", ".png", *opts]
            os.environ["LOG_TPU_BACKEND"] = backend
            t0 = time.perf_counter()
            train.main(["--cfg", cfg, *dev_args, "split", "train",
                        *run_opts])
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            record = final_val.main([*dev_args, cfg, last_checkpoint(exp),
                                     *run_opts])
            res["runs"][backend] = {
                "train_s": train_s, "final_val_s": time.perf_counter() - t0,
                "val_psnr": val_series(exp),
                "num_points": val_series(exp, "train/num_points"),
                "final_val": {k: float(record[k])
                              for k in ("psnr", "ssim", "l1")}}
    finally:
        if saved is None:
            os.environ.pop("LOG_TPU_BACKEND", None)
        else:
            os.environ["LOG_TPU_BACKEND"] = saved
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", default="config/synthetic/train.yml")
    ap.add_argument("--out", default="output/equiv")
    ap.add_argument("--device", default=None)
    ap.add_argument("opts", nargs="*")
    a = ap.parse_args(argv)
    C.emit(run(a.cfg, a.out, a.opts, device=a.device))


if __name__ == "__main__":
    main()
