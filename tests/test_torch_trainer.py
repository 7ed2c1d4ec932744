"""The port's training loop and CLI against the JAX package: a tiny
two-stage fit through Trainer.fit on the CPU (checkpoints, resume-skip,
validation records, a falling loss), validation and the two-phase render
against log_tpu on the same weights, a port checkpoint rendered by log_tpu,
and the CLI in subprocesses that cannot import JAX."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.render.renderer import NaiveRendererAndLoss as RendererJax
from log_tpu.utils import command as command_jax
from log_tpu.utils import config as config_jax
from log_tpu.utils.trainer import Trainer as TrainerJax
from log_tpu_torch.apps import final_val, make_synthetic_scene, train
from log_tpu_torch.render.renderer import NaiveRendererAndLoss
from log_tpu_torch.utils import command, config
from log_tpu_torch.utils.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
CFG = "config/synthetic/train.yml"
VIEWS = 8
# one view each before the first densify (it keeps what the views since the
# counter reset saw), as the configs' base_iter does
BASE_ITER = 8
# 8-bit frames: two quantization steps
FRAME_TOL = 2.0 / 255.0 + 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors and many ops: one intra-op thread (parallel test
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(scene, exp):
    return ["root", scene, "PLYNAME", f"{scene}/sparse/0/sparse.npz",
            "exp", exp, "dataset.args.ext", ".png",
            "val_dataset.args.ext", ".png",
            "base_iter", str(BASE_ITER), "log_interval", "8",
            "val.iteration", "12",
            "NAIVE_STAGE.init.loader.args.iterations", "3",
            "NAIVE_STAGE.tree.loader.args.iterations", "3",
            "model.args.gaussian.init_ply.init_opacity", "0.5",
            "demo_interpolate.dataset.args.steps", "5",
            "demo_interpolate.dataset.args.subs",
            "['cam/0000', 'cam/0002', 'cam/0004', 'cam/0006', 'cam/0000']"]


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """A 64x80 scene of 8 views (the port's generator on the CPU) and the
    two stages of config/synthetic/train.yml at base_iter 8 through the
    port's CLI in process, with every step's loss recorded."""
    root = tmp_path_factory.mktemp("fit")
    scene, exp = str(root / "scene"), str(root / "out" / "log")
    cwd = os.getcwd()
    os.chdir(REPO)
    losses, records = [], []
    real_step, real_val = Trainer.training_step, Trainer.make_validation

    def step(self, model, data):
        out = real_step(self, model, data)
        losses.append((model.stage_name, float(out[1]["loss_dev"])))
        return out

    def val(self, iteration, visualize=False):
        records.append(real_val(self, iteration, visualize))
        return records[-1]

    Trainer.training_step, Trainer.make_validation = step, val
    threads = torch.get_num_threads()  # as _one_thread, for the module
    torch.set_num_threads(1)
    try:
        make_synthetic_scene.main([scene, "300", str(VIEWS), "64", "80",
                                   ".png", "--device", "cpu"])
        opts = _opts(scene, exp)
        trainer = train.main(["--cfg", CFG, "--device", "cpu", "split",
                              "train"] + opts)
        n_steps = len(losses)
        again = train.main(["--cfg", CFG, "--device", "cpu", "split",
                            "train"] + opts)
    finally:
        Trainer.training_step, Trainer.make_validation = real_step, real_val
        torch.set_num_threads(threads)
        os.chdir(cwd)
    return {"scene": scene, "exp": exp, "opts": opts, "losses": losses,
            "n_steps": n_steps, "records": records, "trainer": trainer,
            "again": again}


def test_fit_checkpoints_resume_and_loss(fit):
    exp = fit["exp"]
    for stage in ("init", "tree"):
        for suffix in ("", "_wotrain"):
            assert os.path.exists(os.path.join(exp, f"model_{stage}{suffix}.pth"))
    wotrain = command.load_statedict(os.path.join(exp, "model_tree_wotrain.pth"))
    assert not any("optimizer" in k or "counter" in k for k in wotrain)
    assert "optimizer.exp_avg.xyz" in command.load_statedict(
        os.path.join(exp, "model_tree.pth"))
    assert os.path.exists(os.path.join(exp, "config.yaml"))
    # 3 x base_iter init and tree steps, then resume-skip takes none
    assert fit["n_steps"] == 6 * BASE_ITER == len(fit["losses"])
    assert fit["again"].model.num_points == fit["trainer"].model.num_points
    assert fit["trainer"].model.current_depth == 20  # upgrade_tree ran
    assert fit["records"] and all(
        {"iteration", "num_points", "l1", "psnr", "ssim"} <= set(r)
        for r in fit["records"])
    loss = np.array([v for _, v in fit["losses"]])
    assert loss[-BASE_ITER:].mean() < loss[:BASE_ITER].mean(), loss


def _models_from(fit, name, split):
    """The port's and the JAX package's LoG with the config's model args
    (without init_ply), both loaded from one port checkpoint."""
    sd = command.load_statedict(os.path.join(fit["exp"], name))
    cfg = config.Config.load(str(REPO / CFG), fit["opts"])
    cfg = command.update_global_variable(cfg, cfg)
    args = config._to_plain(cfg.model.args)
    args["gaussian"].pop("init_ply")
    port = config.load_object(cfg.model.module, args, device="cpu")
    ref = LoGJax(**args)
    for m in (port, ref):
        m.load_state_dict(sd, split=split)
        m.set_state(enable_sh=True)
    return port, ref


def _val_cfgs(fit, tmp_path):
    out = []
    for cfg_mod, cmd_mod, name in ((config_jax, command_jax, "jax"),
                                   (config, command, "port")):
        cfg = cfg_mod.Config.load(str(REPO / CFG), fit["opts"])
        cfg = cmd_mod.update_global_variable(cfg, cfg)
        cfg["exp"] = str(tmp_path / name)
        out.append(cfg)
    return out


def test_validation_matches_jax(fit, tmp_path):
    """make_validation on the same weights (the tree checkpoint): PSNR
    within 0.01 dB, SSIM within 1e-4, L1 within 1e-5."""
    port, ref = _models_from(fit, "model_tree.pth", "val")
    assert port.num_points == ref.num_points
    cfg_j, cfg_p = _val_cfgs(fit, tmp_path)
    t_j = TrainerJax(cfg_j, ref, RendererJax(), logdir=cfg_j.exp)
    t_p = Trainer(cfg_p, port, NaiveRendererAndLoss(device="cpu"))
    try:
        want, got = t_j.make_validation(7), t_p.make_validation(7)
    finally:
        os.close(t_j._exp_lock_fd)
        t_p.close()
    assert got["num_points"] == want["num_points"]
    assert abs(got["psnr"] - want["psnr"]) < 0.01, (got, want)
    assert abs(got["ssim"] - want["ssim"]) < 1e-4, (got, want)
    assert abs(got["l1"] - want["l1"]) < 1e-5, (got, want)
    assert 5.0 < got["psnr"] < 60.0


def _val_batch(fit):
    from log_tpu_torch.dataset.colmap import ImageDataset

    ds = ImageDataset(root=fit["scene"], cameras="", scales=[1], znear=0.001,
                      zfar=100.0, ext=".png", share_camera=True,
                      namelist=["cam/0003"], cache="cache_test.pkl")
    return train._batchify(ds[0])


def test_two_phase_vis_matches_jax(fit):
    """vis of a training-mode model (prepare_from_camera + render_one)
    equals the JAX package's within two 8-bit steps."""
    port, ref = _models_from(fit, "model_tree.pth", "train")
    port.train()
    ref.train()
    batch = _val_batch(fit)
    bg = np.array([0.2, 0.5, 0.8], np.float32)
    got = NaiveRendererAndLoss(device="cpu").vis(batch, port, background=bg)
    want = RendererJax().vis(batch, ref, background=bg)
    assert port.visibility_flag["counts"] == tuple(
        int(c) for c in ref.visibility_flag["counts"])
    for key in ("render", "alpha"):
        assert got[key].shape == want[key].shape
        assert np.abs(got[key] - np.asarray(want[key])).max() <= FRAME_TOL
    assert got["render"].std() > 0.01


@pytest.mark.parametrize("backend", ["reference", "tiled"])
def test_two_phase_vis_on_a_tree_matches_jax(backend, monkeypatch):
    """The same on a three-level synthetic LoD tree, through the oracle and
    through rasterize_tiled(with_stats=False) (the port's plain kernels;
    the JAX kernels in interpret mode)."""
    from log_tpu_torch.dataset.base import prepare_camera
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    monkeypatch.setenv("LOG_TPU_BACKEND", backend)
    ckpt = build_checkpoint(2000, seed=1)
    args = dict(gaussian=dict(xyz_scale=1.0, sh_degree=1),
                optimizer=dict(opt_all_levels=True), densify_and_remove={},
                tree=dict(max_child=4, max_level=30))
    port = config.load_object("LoG.model.level_of_gaussian.LoG", args,
                              device="cpu")
    ref = LoGJax(**args)
    h, w = 64, 128
    pos = np.array([15.0, -12.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    pc = prepare_camera({"K": np.array([[90.0, 0, w / 2], [0, 90.0, h / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                         "W": w, "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0)
    batch = {"camera": {k: np.asarray(pc[k])[None]
                        for k in train._batchify({"camera": pc})["camera"]}}
    outs = []
    for m, renderer in ((port, NaiveRendererAndLoss(device="cpu")),
                        (ref, RendererJax())):
        m.load_state_dict(ckpt)
        m.set_state(enable_sh=True)
        m.train()
        outs.append(renderer.vis(batch, m, background=np.ones(3, np.float32)))
    assert port.tree.num_nodes > 0 and port.current_depth == 2
    assert port.visibility_flag["counts"] == tuple(
        int(c) for c in ref.visibility_flag["counts"])
    got, want = outs
    assert got["render"].std() > 0.01
    # the JAX K1 without stats composites in bf16 (up to 6e-3 here): one
    # more 8-bit step on the tiled path
    tol = FRAME_TOL + (1.0 / 255.0 if backend == "tiled" else 0.0)
    for key in ("render", "alpha"):
        assert np.abs(got[key] - np.asarray(want[key])).max() <= tol


def test_port_checkpoint_renders_in_jax(fit):
    """log_tpu loads a checkpoint the port wrote; its frame (eval mode,
    render_fused) agrees with the port's within the frame tolerance of the
    serving tests (5e-3) and two 8-bit steps through vis."""
    port, ref = _models_from(fit, "model_tree.pth", "demo")
    port.eval()
    ref.eval()
    batch = _val_batch(fit)
    camera = {k: np.asarray(v)[0] for k, v in batch["camera"].items()}
    out = port.render_fused(camera, np.ones(3, np.float32))
    out_j = ref.render_fused(camera, np.ones(3, np.float32))
    np.testing.assert_allclose(out["render"].numpy(),
                               np.asarray(out_j["render"]), atol=5e-3)
    got = NaiveRendererAndLoss(device="cpu").vis(batch, port)
    want = RendererJax().vis(batch, ref)
    assert np.abs(got["render"] - np.asarray(want["render"])).max() <= FRAME_TOL


def test_cli_in_subprocess_without_jax(fit, tmp_path):
    """python -m log_tpu_torch.apps.{train,final_val} --device cpu: train
    (the checkpoints exist: resume-skip), demo_interpolate, val and
    final_val, each in an interpreter where importing jax raises (that no
    module imports log_tpu is test_torch_no_jax.py's)."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('the port imported jax')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(fake.parent), str(REPO)]))
    ck = os.path.join(fit["exp"], "model_tree.pth")
    base = [sys.executable, "-m", "log_tpu_torch.apps.train", "--cfg", CFG,
            "--device", "cpu", "split"]
    runs = {
        "train": base + ["train"],
        "demo": base + ["demo_interpolate", "ckptname", ck],
        "val": base + ["val", "ckptname", ck],
        "final_val": [sys.executable, "-m", "log_tpu_torch.apps.final_val",
                      CFG, ck, "--device", "cpu"],
    }
    out = {}
    for name, cmd in runs.items():
        proc = subprocess.run(cmd + fit["opts"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, (name, proc.stderr[-3000:])
        out[name] = proc.stdout
    assert out["train"].count("Load checkpoint:") == 2
    assert "Average time:" in out["demo"] and "scale: 2," in out["val"]
    assert "'psnr':" in out["final_val"] and "'ssim':" in out["final_val"]
    frames = sorted(os.listdir(os.path.join(fit["exp"], "demo_interpolate",
                                            "rgb")))
    assert frames[:5] == [f"{i:06d}.jpg" for i in range(5)]
    for d in ("gt", "renders"):
        assert len(os.listdir(os.path.join(fit["exp"], "test", "scale_2",
                                           d))) == 2


def test_cuda_request_without_cuda_raises(fit):
    """Entry points run on cuda unless asked for the CPU, and never fall
    back to it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.resolve_device("cuda")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--cfg", CFG, "split", "val"] + fit["opts"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            final_val.main([CFG, os.path.join(fit["exp"], "model_tree.pth")]
                           + fit["opts"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_synthetic_scene.main([str(Path(fit["exp"]) / "s")])
    finally:
        os.chdir(cwd)


class _Model:
    device = torch.device("cpu")


def test_trainer_exp_lock_and_parallel(tmp_path):
    cfg = config.CfgNode({"exp": str(tmp_path / "exp")})
    first = Trainer(cfg, _Model(), None)
    with pytest.raises(RuntimeError, match="locked by a running trainer"):
        Trainer(cfg, _Model(), None)
    first.close()
    Trainer(cfg, _Model(), None).close()
    # cfg.train.parallel (log_tpu_torch/parallel): "on" takes the sharded
    # step at any group size, one rank too; "auto" only past one rank
    for enable, want in ((True, 1), ("on", 1), ("auto", 0), ("off", 0)):
        par = config.CfgNode({"train": {"parallel": {"enable": enable}}})
        trainer = Trainer(par, _Model(), None)
        assert trainer._parallel_requested() == want, enable
        trainer.close()
    # one device per rank: n_devices must be the group's size
    par = config.CfgNode({"train": {"parallel": {"enable": "on",
                                                 "n_devices": 2}}})
    with pytest.raises(ValueError, match="one device per rank"):
        Trainer(par, _Model(), None)._parallel_requested()
