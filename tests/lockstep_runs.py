"""Both packages' training CLIs on one scene, config and seed, recorded
step by step (the harness of tests/test_torch_lockstep_*.py).

`run_both` makes a scene with the port's `make_synthetic_scene` (the
SyntheticDataset of both packages), gives each package a copy of it and
runs `apps/train.py` (the JAX package's CLI) and `log_tpu_torch.apps.train`
in this process with the same config and overrides on
`LOG_TPU_BACKEND=reference` (the two packages' tiled rasterizers differ in
float order, ROADMAP fact i). It records, for each package:
- every step: the view drawn, the background, the LR of each key (the
  model's `_host_lrs` after the step's count advanced, as the float32
  scalar that the step receives: the JAX package keeps its LR table in
  float32, the port in float64) and the loss;
- every densify and upgrade (`update_by_iteration` returning True): the
  global iteration, the point count, the capacity and the tree depth;
- every validation record;
- the final checkpoint of the last stage;
- the state of the model's densify stream at the first step, and of each
  dataset's crop stream as it was built (the CLI seeds them from the
  global numpy state after seed_everything(666)).

`compare` holds the port's run against the JAX package's with the limits
that the lockstep tests state. Nothing is carried across: both runs start
from the same files and seed and draw the same random numbers
(`log_tpu_torch/utils/jax_random.py`).
"""
from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
CFG = "config/synthetic/train.yml"
VIEWS = 8
# one view each before the first densify (it keeps what the views since
# the counter reset saw; ROADMAP fact z)
BASE_ITER = 8

LOSS_RTOL = 1e-4
PSNR_ATOL = 0.02
SSIM_ATOL = 1e-3
# The final parameters: 95% of each key's values within PARAM_ATOL and all
# within PARAM_MAX. The two packages' steps differ in float order (the
# losses by up to 4.2e-6 relative), and Adam turns a gradient that is
# within float noise of zero into a full LR-sized step of either sign: the
# largest gaps sit on such rows (rotation 9.0e-3 and opacity 1.0e-3 in the
# lockstep runs, every other value within 4e-5).
PARAM_ATOL = 1e-4
PARAM_SHARE = 0.95
PARAM_MAX = 0.02


def opts(scene: str, exp: str, extra=()) -> list:
    """tests/test_torch_trainer.py's overrides: base_iter 8, 3 + 3 loader
    iterations (48 steps), validation every 12, init opacity 0.5."""
    return ["root", scene, "PLYNAME", f"{scene}/sparse/0/sparse.npz",
            "exp", exp, "dataset.args.ext", ".png",
            "val_dataset.args.ext", ".png",
            "base_iter", str(BASE_ITER), "log_interval", "8",
            "val.iteration", "12",
            "NAIVE_STAGE.init.loader.args.iterations", "3",
            "NAIVE_STAGE.tree.loader.args.iterations", "3",
            "model.args.gaussian.init_ply.init_opacity", "0.5",
            *extra]


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _hook(monkeypatch, model_cls, trainer_cls, dataset_cls, host_lrs,
          rec: dict):
    """Record every step, densify and validation of one package's run."""
    real_iter = model_cls.training_iteration
    real_update = model_cls.update_by_iteration
    real_val = trainer_cls.make_validation
    real_init = dataset_cls.__init__

    def dataset_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        rec["streams"].append(self.rng.bit_generator.state)

    def training_iteration(self, camera, gt_image, background, *args,
                           **kwargs):
        if not rec["steps"]:
            rec["streams"].append(self._rng.bit_generator.state)
        out = real_iter(self, camera, gt_image, background, *args, **kwargs)
        rec["steps"].append({
            "view": int(kwargs["view_index"]),
            "background": _as_numpy(background).astype(np.float32),
            "lrs": {k: np.float32(v) for k, v in host_lrs(
                self.optimizer, self.optimizer.global_steps).items()},
            "loss": float(_as_numpy(out[0]["loss"])),
        })
        return out

    def update_by_iteration(self, iteration, global_iteration):
        flag = real_update(self, iteration, global_iteration)
        if flag:
            rec["events"].append((int(global_iteration), self.num_points,
                                  self.capacity, self.current_depth))
        return flag

    def make_validation(self, iteration, visualize=False):
        rec["vals"].append(real_val(self, iteration, visualize))
        return rec["vals"][-1]

    monkeypatch.setattr(model_cls, "training_iteration", training_iteration)
    monkeypatch.setattr(model_cls, "update_by_iteration", update_by_iteration)
    monkeypatch.setattr(trainer_cls, "make_validation", make_validation)
    monkeypatch.setattr(dataset_cls, "__init__", dataset_init)


def _run_jax(argv, monkeypatch, rec):
    import apps.train as cli
    from log_tpu.dataset.colmap import ImageDataset
    from log_tpu.model import level_of_gaussian as log_mod
    from log_tpu.utils import trainer as trainer_mod

    _hook(monkeypatch, log_mod.LoG, trainer_mod.Trainer, ImageDataset,
          log_mod._host_lrs, rec)
    # the code snapshot copies the checkout; the runs need none
    monkeypatch.setattr(cli, "copy_git_tracked_files",
                        lambda src, exp: os.path.join(exp, "code"))
    monkeypatch.setattr(sys, "argv", ["apps/train.py"] + argv)
    cli.main()


def _run_port(argv, monkeypatch, rec):
    from log_tpu_torch.apps import train as cli
    from log_tpu_torch.dataset.colmap import ImageDataset
    from log_tpu_torch.model import level_of_gaussian as log_mod
    from log_tpu_torch.utils import trainer as trainer_mod

    _hook(monkeypatch, log_mod.LoG, trainer_mod.Trainer, ImageDataset,
          log_mod._host_lrs, rec)
    monkeypatch.setattr(cli, "copy_git_tracked_files",
                        lambda src, exp: os.path.join(exp, "code"))
    cli.main(argv[:2] + ["--device", "cpu"] + argv[2:])


def run_both(root: Path, extra=(), scene_maker=None) -> dict:
    """{'jax': record, 'port': record} of both CLIs' `split train` on one
    scene; a record holds 'steps', 'events', 'vals' and 'final' (the last
    stage's checkpoint as numpy arrays). scene_maker(path) writes the
    scene (default: the port's make_synthetic_scene, 300 Gaussians, 8
    views at 64x80, .png)."""
    import pytest

    from log_tpu_torch.apps import make_synthetic_scene
    from log_tpu_torch.utils.command import load_statedict

    scene = root / "scene"
    if scene_maker is None:
        make_synthetic_scene.main([str(scene), "300", str(VIEWS), "64", "80",
                                   ".png", "--device", "cpu"])
    else:
        scene_maker(scene)
    out = {}
    cwd = os.getcwd()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        os.chdir(REPO)
        for name, run in (("jax", _run_jax), ("port", _run_port)):
            copy = root / f"scene_{name}"
            shutil.copytree(scene, copy)
            exp = root / f"exp_{name}"
            rec = {"steps": [], "events": [], "vals": [], "streams": []}
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("LOG_TPU_BACKEND", "reference")
                run(["--cfg", CFG, "split", "train"]
                    + opts(str(copy), str(exp), extra), mp, rec)
            rec["final"] = load_statedict(str(exp / "model_tree.pth"))
            out[name] = rec
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    return out


def compare(runs: dict) -> dict:
    """Assert the lockstep limits; returns the largest gaps seen."""
    want, got = runs["jax"], runs["port"]
    # the streams first: the train and val datasets' and the model's
    assert len(got["streams"]) == len(want["streams"]) == 3
    assert got["streams"] == want["streams"]
    # then the densifies: a different keep mask shows as a point count
    assert got["events"] == want["events"], (got["events"], want["events"])
    assert len(got["steps"]) == len(want["steps"]) > 0
    loss_gap = 0.0
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g["view"] == w["view"], (i, g["view"], w["view"])
        np.testing.assert_array_equal(g["background"], w["background"],
                                      err_msg=f"step {i}")
        assert g["lrs"] == w["lrs"], (i, g["lrs"], w["lrs"])
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        assert rel <= LOSS_RTOL, (i, g["loss"], w["loss"])
        loss_gap = max(loss_gap, rel)
    assert len(got["vals"]) == len(want["vals"]) > 0
    psnr_gap = ssim_gap = 0.0
    for g, w in zip(got["vals"], want["vals"]):
        assert g["iteration"] == w["iteration"]
        assert g["num_points"] == w["num_points"]
        psnr_gap = max(psnr_gap, abs(g["psnr"] - w["psnr"]))
        ssim_gap = max(ssim_gap, abs(g["ssim"] - w["ssim"]))
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_ATOL, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= SSIM_ATOL, (g, w)
    param_gap = {}
    for key in ("xyz", "colors", "scaling", "opacity", "rotation", "shs"):
        k = f"gaussian.{key}"
        g, w = np.asarray(got["final"][k]), np.asarray(want["final"][k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        gap = np.abs(g - w)
        assert (gap <= PARAM_ATOL).mean() >= PARAM_SHARE, (k, np.sort(
            gap.ravel())[-10:])
        assert gap.max() <= PARAM_MAX, (k, gap.max())
        param_gap[key] = float(gap.max())
    for key in ("tree.depth", "tree.index_parent"):
        np.testing.assert_array_equal(got["final"][key], want["final"][key])
    return {"loss_rel": loss_gap, "psnr": psnr_gap, "ssim": ssim_gap,
            "params_abs": param_gap}
