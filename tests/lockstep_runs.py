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

`run_both_sharded` runs both CLIs under config/synthetic_parallel at RANKS
ranks: the JAX CLI in this process on the conftest's virtual CPU devices
(train.parallel.n_devices), the port's CLI at RANKS gloo ranks
(parallel/launch.spawn, one torch thread each). It records every sharded
step (the batch's views, backgrounds, LoD thresholds, float32 LRs, slice
bucket and loss), every re-shard (point count, capacity, each rank's
rows), the densifies, validations and final checkpoint, and the port's
rank models; `compare_sharded` holds them with `compare`'s limits.
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


def opts(scene: str, exp: str, extra=(), base_iter=BASE_ITER,
         iterations=3, val_every=12) -> list:
    """tests/test_torch_trainer.py's overrides: base_iter 8, 3 + 3 loader
    iterations (48 steps), validation every 12, init opacity 0.5."""
    return ["root", scene, "PLYNAME", f"{scene}/sparse/0/sparse.npz",
            "exp", exp, "dataset.args.ext", ".png",
            "val_dataset.args.ext", ".png",
            "base_iter", str(base_iter), "log_interval", str(base_iter),
            "val.iteration", str(val_every),
            "NAIVE_STAGE.init.loader.args.iterations", str(iterations),
            "NAIVE_STAGE.tree.loader.args.iterations", str(iterations),
            "model.args.gaussian.init_ply.init_opacity", "0.5",
            *extra]


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _new_record() -> dict:
    return {"steps": [], "events": [], "vals": [], "streams": [],
            "reshards": []}


def _hook_run(monkeypatch, model_cls, trainer_cls, dataset_cls, rec: dict):
    """Record every densify, validation and dataset stream of a run."""
    real_update = model_cls.update_by_iteration
    real_val = trainer_cls.make_validation
    real_init = dataset_cls.__init__

    def dataset_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        rec["streams"].append(self.rng.bit_generator.state)

    def update_by_iteration(self, iteration, global_iteration):
        flag = real_update(self, iteration, global_iteration)
        if flag:
            rec["events"].append((int(global_iteration), self.num_points,
                                  self.capacity, self.current_depth))
        return flag

    def make_validation(self, iteration, visualize=False):
        rec["vals"].append(real_val(self, iteration, visualize))
        return rec["vals"][-1]

    monkeypatch.setattr(model_cls, "update_by_iteration", update_by_iteration)
    monkeypatch.setattr(trainer_cls, "make_validation", make_validation)
    monkeypatch.setattr(dataset_cls, "__init__", dataset_init)


def _hook(monkeypatch, model_cls, trainer_cls, dataset_cls, host_lrs,
          rec: dict):
    """Record every step, densify and validation of one package's run."""
    _hook_run(monkeypatch, model_cls, trainer_cls, dataset_cls, rec)
    real_iter = model_cls.training_iteration

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

    monkeypatch.setattr(model_cls, "training_iteration", training_iteration)


def _jax_cli(argv, monkeypatch):
    import apps.train as cli

    # the code snapshot copies the checkout; the runs need none
    monkeypatch.setattr(cli, "copy_git_tracked_files",
                        lambda src, exp: os.path.join(exp, "code"))
    monkeypatch.setattr(sys, "argv", ["apps/train.py"] + argv)
    cli.main()


def _port_cli(argv, monkeypatch):
    from log_tpu_torch.apps import train as cli

    monkeypatch.setattr(cli, "copy_git_tracked_files",
                        lambda src, exp: os.path.join(exp, "code"))
    return cli.main(argv[:2] + ["--device", "cpu"] + argv[2:])


def _run_jax(argv, monkeypatch, rec):
    from log_tpu.dataset.colmap import ImageDataset
    from log_tpu.model import level_of_gaussian as log_mod
    from log_tpu.utils import trainer as trainer_mod

    _hook(monkeypatch, log_mod.LoG, trainer_mod.Trainer, ImageDataset,
          log_mod._host_lrs, rec)
    _jax_cli(argv, monkeypatch)


def _run_port(argv, monkeypatch, rec):
    from log_tpu_torch.dataset.colmap import ImageDataset
    from log_tpu_torch.model import level_of_gaussian as log_mod
    from log_tpu_torch.utils import trainer as trainer_mod

    _hook(monkeypatch, log_mod.LoG, trainer_mod.Trainer, ImageDataset,
          log_mod._host_lrs, rec)
    _port_cli(argv, monkeypatch)


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
            rec = _new_record()
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
    psnr_gap, ssim_gap = _compare_vals(got["vals"], want["vals"])
    param_gap = _compare_final(got["final"], want["final"])
    return {"loss_rel": loss_gap, "psnr": psnr_gap, "ssim": ssim_gap,
            "params_abs": param_gap}


def _compare_vals(got: list, want: list):
    """Every validation record within PSNR_ATOL and SSIM_ATOL; returns the
    largest gaps."""
    assert len(got) == len(want) > 0
    psnr_gap = ssim_gap = 0.0
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"]
        assert g["num_points"] == w["num_points"]
        psnr_gap = max(psnr_gap, abs(g["psnr"] - w["psnr"]))
        ssim_gap = max(ssim_gap, abs(g["ssim"] - w["ssim"]))
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_ATOL, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= SSIM_ATOL, (g, w)
    return psnr_gap, ssim_gap


def _compare_final(got: dict, want: dict) -> dict:
    """The final checkpoints' parameters within PARAM_ATOL / PARAM_SHARE /
    PARAM_MAX and their trees equal; returns each key's largest gap."""
    param_gap = {}
    for key in ("xyz", "colors", "scaling", "opacity", "rotation", "shs"):
        k = f"gaussian.{key}"
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        gap = np.abs(g - w)
        assert (gap <= PARAM_ATOL).mean() >= PARAM_SHARE, (k, np.sort(
            gap.ravel())[-10:])
        assert gap.max() <= PARAM_MAX, (k, gap.max())
        param_gap[key] = float(gap.max())
    for key in ("tree.depth", "tree.index_parent"):
        np.testing.assert_array_equal(got[key], want[key])
    return param_gap


# ---------------------------------------------------- the sharded CLI run
SHARDED_CFG = "config/synthetic_parallel/train.yml"
RANKS = 2
# 2 stages x base_iter 4 x 3 loader iterations: 24 sharded steps of 2
# cameras. The schedule runs update_by_iteration after every batch but a
# stage's last, so 2 loader iterations (8 batches) reach only the counter
# reset at batch 4; 3 reach the init densify and the upgrade at batch 8.
SHARDED_BASE_ITER = 4
SHARDED_ITERATIONS = 3
SHARDED_VAL_EVERY = 8
RANK_TIMEOUT_S = 300


def sharded_opts(scene: str, exp: str, extra=()) -> list:
    return opts(scene, exp, ["train.parallel.n_devices", str(RANKS),
                             *extra],
                base_iter=SHARDED_BASE_ITER, iterations=SHARDED_ITERATIONS,
                val_every=SHARDED_VAL_EVERY)


def _hook_sharded(monkeypatch, executor_cls, model_cls, trainer_cls,
                  dataset_cls, host_lrs, rows, rec: dict):
    """Record every sharded step, re-shard, densify and validation of one
    package's run; rows(executor) -> the row count of each rank's block."""
    _hook_run(monkeypatch, model_cls, trainer_cls, dataset_cls, rec)
    real_step = executor_cls.step
    real_refresh = executor_cls.refresh_from_model

    def step(self, cameras, gts, view_indices=None, backgrounds=None,
             min_res=None):
        if not rec["steps"]:
            rec["streams"].append(self.model._rng.bit_generator.state)
        metrics, counts = real_step(self, cameras, gts, view_indices,
                                    backgrounds, min_res)
        opt = self.model.optimizer
        rec["steps"].append({
            "views": [int(v) for v in view_indices],
            "backgrounds": np.asarray(backgrounds, np.float32),
            "min_res": [float(m) for m in min_res],
            "lrs": {k: np.float32(v) for k, v in host_lrs(
                opt, opt.global_steps).items()},
            "loss": float(_as_numpy(metrics["loss"])),
            "bucket": tuple(int(b) for b in self._bucket),
        })
        return metrics, counts

    def refresh_from_model(self):
        real_refresh(self)
        m = self.model
        rec["reshards"].append((m.num_points, m.capacity, rows(self)))

    monkeypatch.setattr(executor_cls, "step", step)
    monkeypatch.setattr(executor_cls, "refresh_from_model",
                        refresh_from_model)


def _run_jax_sharded(argv, monkeypatch, rec):
    """The JAX CLI on RANKS of the conftest's virtual CPU devices."""
    from log_tpu.dataset.colmap import ImageDataset
    from log_tpu.model import level_of_gaussian as log_mod
    from log_tpu.parallel.executor import ShardedExecutor
    from log_tpu.utils import trainer as trainer_mod

    def rows(ex):
        shards = sorted(ex.packed.addressable_shards,
                        key=lambda s: s.device.id)
        return [int(s.data.shape[0]) for s in shards]

    _hook_sharded(monkeypatch, ShardedExecutor, log_mod.LoG,
                  trainer_mod.Trainer, ImageDataset, log_mod._host_lrs, rows,
                  rec)
    _jax_cli(argv, monkeypatch)


def _port_rank(rank, world, device, argv):
    """One gloo rank of the port's CLI (parallel/launch.spawn): its record,
    its block's rows at every re-shard and its final model."""
    import pytest

    from log_tpu_torch.dataset.colmap import ImageDataset
    from log_tpu_torch.model import level_of_gaussian as log_mod
    from log_tpu_torch.parallel.executor import ShardedExecutor
    from log_tpu_torch.utils import trainer as trainer_mod

    rec = _new_record()
    with pytest.MonkeyPatch.context() as mp:
        _hook_sharded(mp, ShardedExecutor, log_mod.LoG, trainer_mod.Trainer,
                      ImageDataset, log_mod._host_lrs,
                      lambda ex: int(ex.packed.shape[0]), rec)
        trainer = _port_cli(argv, mp)
    rec["model"] = {k: np.array(_as_numpy(v))
                    for k, v in trainer.model.state_dict().items()}
    rec["jax"] = "jax" in sys.modules
    return rec


def run_both_sharded(root: Path, extra=()) -> dict:
    """{'jax': record, 'port': record, 'port_rank1': record} of both CLIs'
    `split train` under config/synthetic_parallel on RANKS ranks, on the
    lockstep scene (300 Gaussians, 8 views at 64x80, .png). A record holds
    'steps' (per sharded step: the batch's views, backgrounds, LoD
    min_res, float32 LRs and loss), 'reshards' (point count, capacity and
    each rank's rows after every refresh_from_model), 'events', 'vals',
    'streams' and 'final' (the last stage's checkpoint); the port's rank
    records also 'model', the rank's model after the run."""
    import pytest

    from log_tpu_torch.apps import make_synthetic_scene
    from log_tpu_torch.parallel.launch import spawn
    from log_tpu_torch.utils.command import load_statedict

    scene = root / "scene"
    make_synthetic_scene.main([str(scene), "300", str(VIEWS), "64", "80",
                               ".png", "--device", "cpu"])
    out = {}
    cwd = os.getcwd()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        os.chdir(REPO)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LOG_TPU_BACKEND", "reference")
            for name in ("jax", "port"):
                copy = root / f"scene_{name}"
                shutil.copytree(scene, copy)
                exp = root / f"exp_{name}"
                argv = (["--cfg", SHARDED_CFG, "split", "train"]
                        + sharded_opts(str(copy), str(exp), extra))
                if name == "jax":
                    rec = _new_record()
                    with pytest.MonkeyPatch.context() as mpj:
                        _run_jax_sharded(argv, mpj, rec)
                else:
                    rec, rank1 = spawn(_port_rank, RANKS, "cpu",
                                       args=(argv,),
                                       timeout_s=RANK_TIMEOUT_S)
                    assert len(rec["reshards"]) == len(rank1["reshards"])
                    rec["reshards"] = [
                        (n, cap, [rows, r1[2]]) if (n, cap) == r1[:2]
                        else (n, cap, ("rank 1", r1))
                        for (n, cap, rows), r1 in zip(rec["reshards"],
                                                      rank1["reshards"])]
                    out["port_rank1"] = rank1
                rec["final"] = load_statedict(str(exp / "model_tree.pth"))
                out[name] = rec
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    return out


def compare_sharded(runs: dict) -> dict:
    """Assert the sharded lockstep's limits (those of `compare`, per
    sharded step); returns the largest gaps seen."""
    want, got, rank1 = runs["jax"], runs["port"], runs["port_rank1"]
    assert not got["jax"] and not rank1["jax"]  # no rank imported JAX
    assert len(got["streams"]) == len(want["streams"]) == 3
    assert got["streams"] == want["streams"]
    assert got["events"] == want["events"], (got["events"], want["events"])
    # the re-shards: point count, capacity and each rank's rows
    assert got["reshards"] == want["reshards"], (got["reshards"],
                                                 want["reshards"])
    assert len(got["steps"]) == len(want["steps"]) > 0
    loss_gap = 0.0
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        assert g["views"] == w["views"], (i, g["views"], w["views"])
        np.testing.assert_array_equal(g["backgrounds"], w["backgrounds"],
                                      err_msg=f"step {i}")
        assert g["min_res"] == w["min_res"], (i, g["min_res"], w["min_res"])
        assert g["lrs"] == w["lrs"], (i, g["lrs"], w["lrs"])
        assert g["bucket"] == w["bucket"], (i, g["bucket"], w["bucket"])
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        assert rel <= LOSS_RTOL, (i, g["loss"], w["loss"])
        loss_gap = max(loss_gap, rel)
    psnr_gap, ssim_gap = _compare_vals(got["vals"], want["vals"])
    param_gap = _compare_final(got["final"], want["final"])
    # the ranks: the same steps, and the same model bit for bit
    assert [s["loss"] for s in rank1["steps"]] == [s["loss"]
                                                  for s in got["steps"]]
    assert rank1["model"].keys() == got["model"].keys()
    for k, v in got["model"].items():
        np.testing.assert_array_equal(rank1["model"][k], v, err_msg=k)
    return {"loss_rel": loss_gap, "psnr": psnr_gap, "ssim": ssim_gap,
            "params_abs": param_gap}
