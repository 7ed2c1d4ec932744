"""Final validation of a finished training run, as in training: load the
checkpoint, restore the trained SH degree (enable_sh), and run
Trainer.make_validation (white background, least-squares per-view gain,
L1 / PSNR / SSIM) into <ckpt dir>/final_val.

    python -m log_tpu_torch.apps.final_val [cfg] [ckpt] [--device cuda|cpu]
        [key value ...]

Returns (and prints) the validation record.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("cfg", nargs="?",
                        default="config/synthetic_conv/train.yml")
    parser.add_argument("ckpt", nargs="?",
                        default="output/synthetic_conv/log/model_tree_full.pth")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    from ..utils.command import load_statedict, update_global_variable
    from ..utils.config import Config, load_object
    from ..utils.trainer import Trainer
    from .train import resolve_device

    device = resolve_device(args.device)
    cfg = Config.load(args.cfg, args.opts)
    cfg = update_global_variable(cfg, cfg)
    cfg["split"] = "val"
    exp = os.path.join(os.path.dirname(args.ckpt), "final_val")
    cfg["exp"] = exp
    model = load_object(cfg.model.module, cfg.model.args, device=device)
    model.base_iter = cfg.get("base_iter", 100)
    model.load_state_dict(load_statedict(args.ckpt), split="val")
    model.set_state(enable_sh=True)
    renderer = load_object(cfg.train.render.module, cfg.train.render.args,
                           device=device)
    trainer = Trainer(cfg, model, renderer, logdir=exp)
    try:
        record = trainer.make_validation(999999)
    finally:
        trainer.close()
    print(record)
    return record


if __name__ == "__main__":
    main()
