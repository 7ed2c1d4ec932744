"""The train / val / demo_* splits of a YAML config, on the port.

    python -m log_tpu_torch.apps.train --cfg X.yml [--device cuda|cpu] \
        split train|val|demo_<name> [key value ...]

The same argv, YAML and outputs as the JAX package's apps/train.py: the
base_iter rule, the code snapshot and config.yaml of a training run, the
init pass and Trainer.fit; the demo splits' 11-frame warm-up, timed render
loop, frames under <exp>/<split>/<render_type> (rgb, or with render_type
depth / height the map in Spectral colors) and video; the val split's gt/renders
dumps per scale. --device (default cuda) is where the model, renderer and
trainer run; asking for cuda where there is none is an error.

Multi-device training (cfg.train.parallel, parallel/): one process per
rank, started by torchrun,

    python -m torch.distributed.run --nproc_per_node N \
        -m log_tpu_torch.apps.train --cfg X.yml split train

(or with LOG_TPU_COORDINATOR, LOG_TPU_NUM_PROCESSES and
LOG_TPU_PROCESS_ID set). The process group starts before the model is built:
NCCL with rank r on cuda:LOCAL_RANK, or gloo with --device cpu. Rank 0
writes the exp dir. Without those variables the run has one rank, and
train.parallel.enable on runs the sharded step on it.
"""
from __future__ import annotations

import os
from os.path import join

import numpy as np
import torch

from ..parallel.comm import group_initialized
from ..parallel.mesh import initialize_distributed
from ..utils import image_io
from ..utils.command import (copy_git_tracked_files, load_statedict,
                             update_global_variable)
from ..utils.config import Config, load_object
from ..utils.profiler import Timer, profile_if


def resolve_device(name: str) -> torch.device:
    """The device the CLI was asked for; cuda without a CUDA device is an
    error, never a fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(pass --device cpu to run on the CPU)")
    return device


def _batchify(item):
    batch = {"camera": {k: np.asarray(v)[None] for k, v in item["camera"].items()}}
    for key in ("index", "true_index"):
        if key in item:
            batch[key] = np.asarray([item[key]])
    for key in ("image", "mask", "mask_ignore"):
        if key in item and isinstance(item[key], np.ndarray):
            batch[key] = item[key][None]
    if "imgname" in item:
        batch["imgname"] = [item["imgname"]]
    return batch


def demo(cfg, model, device):
    """Render the split's camera path: 11 warm-up frames, then every frame
    timed and written to <exp>/<split>/<render_type>/%06d.jpg, then a video.
    Returns the mean frame time in ms."""
    split = cfg[cfg.split]
    dataset = load_object(split.dataset.module, split.dataset.args)
    node = split.render if "render" in split else cfg.train.render
    renderer = load_object(node.module, node.args, device=device)
    if "render" not in split:
        renderer.split = "demo"
    model.eval()
    if "model_state" in split:
        model.set_state(**split["model_state"])
    if "render_state" in split:
        renderer.set_state(**split["render_state"])
    # the inference row layout (block-pruned frames); opt out per split
    # with `optimize_layout: False`
    if split.get("optimize_layout", True):
        try:
            model.optimize_render_layout()
        except AssertionError:
            pass  # training state attached: keep the unpruned path
    cre = split.get("check_render_every", None)
    if cre is not None:
        model.set_state(check_render_every=int(cre))
    render_type = cfg.get("render_type", "rgb")
    if render_type in ("depth", "height"):
        renderer.render_depth = True

    for batch_idx in range(min(11, len(dataset))):
        renderer.vis(_batchify(dataset[batch_idx]), model)

    timer = Timer(device)
    outname = None
    for batch_idx in range(len(dataset)):
        item = dataset[batch_idx]
        batch = _batchify(item)
        if "model_state" in item:
            model.set_state(**item["model_state"])
        with timer.measure():
            output = renderer.vis(batch, model)
        if render_type in ("depth", "height"):
            # the map normalized by the config's range, Spectral colors
            lo, hi = (cfg.get(f"{render_type}_min", 0.01),
                      cfg.get(f"{render_type}_max", 10.0))
            vis = renderer.marigold_depth_vis(
                (output[render_type][0] - lo) / (hi - lo))
        else:
            vis = renderer.tensor_to_bgr(output["render"][0])
        outname = image_io.imwrite(
            join(cfg.exp, cfg.split, render_type, f"{batch_idx:06d}.jpg"), vis)
        if "mask" in output and cfg.get("write_rgba", False):
            mask8 = (np.clip(output["mask"][0], 0, 1) * 255).astype(np.uint8)
            image_io.imwrite(
                join(cfg.exp, cfg.split, "rgba", f"{batch_idx:06d}.png"),
                np.dstack([vis, mask8[:, :, None]]))
    timer.report()
    if outname is not None:
        renderer.make_video(os.path.dirname(outname),
                            fps=split.get("fps", 30))
    return timer.mean_ms


def validate_for_metric(exp, dataset, model, renderer, device):
    """Render every view of the dataset at each of its scales (8, 4, 2, 1)
    into <exp>/test/scale_<s>/{gt,renders}/%04d.png; returns the mean frame
    ms by scale."""
    model.eval()
    out = {}
    for scale in [8, 4, 2, 1]:
        if scale not in dataset.scales:
            continue
        dataset.set_state(scale=scale)
        outdir = join(exp, "test", f"scale_{scale}")
        timer = Timer(device)
        for batch_idx in range(len(dataset)):
            item = dataset[batch_idx]
            batch = _batchify(item)
            with timer.measure():
                output = renderer.vis(batch, model)
            if isinstance(item.get("image"), np.ndarray):
                gt = (item["image"][:, :, ::-1] * 255).astype(np.uint8)
                image_io.imwrite(join(outdir, "gt", "%04d.png" % batch_idx), gt)
            renders = output["render"][0].transpose(1, 2, 0)
            renders = (np.clip(renders[:, :, ::-1], 0.0, 1.0) * 255).astype(np.uint8)
            image_io.imwrite(join(outdir, "renders", "%04d.png" % batch_idx),
                             renders)
        timer.report(f"scale: {scale}, ")
        out[scale] = timer.mean_ms
    return out


def main(argv=None):
    args, cfg = Config.load_args(argv, usage="run")
    cfg = update_global_variable(cfg, cfg)
    device = resolve_device(args.device)
    # a group started by the caller (parallel/launch.py) is used as it is
    rank_device = (None if group_initialized()
                   else initialize_distributed(device=device))
    main_rank = not group_initialized() or torch.distributed.get_rank() == 0
    try:
        return _run(args, cfg, rank_device or device, main_rank)
    finally:
        if rank_device is not None:
            torch.distributed.destroy_process_group()


def _run(args, cfg, device, main_rank: bool):
    exp = cfg.exp
    print("Write to {}".format(exp))
    if main_rank:
        os.makedirs(exp, exist_ok=True)
    if cfg.split == "train" and main_rank:
        with open(os.path.join(exp, "config.yaml"), "w") as f:
            print(cfg, file=f)
    from ..utils.trainer import Trainer, seed_everything

    seed_everything(666)
    # the JAX model's constructor seeds its densify stream with the first
    # global draw after seed_everything, and the dataset's crop stream
    # takes the second: the port draws them in the same order
    model = load_object(cfg.model.module, cfg.model.args, device=device,
                        seed=int(np.random.randint(0, 2**31 - 1)))
    if cfg.split == "train":
        outdir = copy_git_tracked_files("./", exp) if main_rank else None
        dataset = load_object(cfg.train.dataset.module, cfg.train.dataset.args)
        if "base_iter" in cfg:
            base_iter = cfg.base_iter
        elif len(dataset) < 1000:
            base_iter = (len(dataset) // 100 + 1) * 100
        else:
            base_iter = (len(dataset) // 1000 + 1) * 1000
        print("Base iteration: {}".format(base_iter))
        model.base_iter = base_iter
        renderer = load_object(cfg.train.render.module, cfg.train.render.args,
                               device=device)
        trainer = Trainer(cfg, model, renderer, logdir=outdir)
        try:
            trainer.init(dataset)
            trainer.fit(dataset)
        finally:
            trainer.close()
        return trainer
    if cfg.split.startswith("demo") or cfg.split == "trainvis":
        if cfg.split == "trainvis":
            cfg.split = "train"
        if "ckptname" in cfg:
            model.load_state_dict(load_statedict(cfg.ckptname))
        with profile_if(args.profiler, join(exp, "torch_trace")):
            return demo(cfg, model, device)
    if cfg.split == "val":
        if "ckptname" in cfg:
            model.load_state_dict(load_statedict(cfg.ckptname))
        if "model_state" in cfg.val:
            model.set_state(**cfg.val["model_state"])
        dataset = load_object(cfg.val.dataset.module, cfg.val.dataset.args)
        renderer = load_object(cfg.train.render.module, cfg.train.render.args,
                               device=device)
        renderer.split = "val"
        return validate_for_metric(exp, dataset, model, renderer, device)
    raise ValueError(f"unknown split {cfg.split!r}")


if __name__ == "__main__":
    main()
