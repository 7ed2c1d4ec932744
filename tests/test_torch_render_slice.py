"""The serving slice end to end: one synthetic LoD-tree checkpoint loaded into
log_tpu's LoG and into log_tpu_torch's LoG, rendered with render_fused from
two orbit cameras through the tiled backend (LOG_TPU_BACKEND=tiled; the JAX
kernels in interpret mode, the port's plain versions on the CPU).

The LoD cut (flat and traverse keep masks) and the counts that size the next
frame must be equal. Images agree to 5e-3: the JAX inference kernel
composites in bf16 (~0.4% relative), the port in float32.
"""
import math
import pickle

import numpy as np
import pytest
import torch

from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.render.renderer import NaiveRendererAndLoss
from log_tpu_torch.utils.command import load_statedict
from log_tpu_torch.utils.config import load_object
from log_tpu_torch.utils.synth_tree import build_checkpoint, tree_sizes

H, W = 128, 256
N_ROOTS = 2000
ARGS = dict(
    gaussian=dict(xyz_scale=1.0, sh_degree=1),
    optimizer=dict(opt_all_levels=True),
    densify_and_remove={},
)


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.delenv("LOG_TPU_TILESTART", raising=False)
    monkeypatch.delenv("LOG_TPU_COMPACT", raising=False)


def _camera(theta):
    pos = np.array([22.0 * math.cos(theta), 22.0 * math.sin(theta), 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[160.0, 0, W / 2], [0, 160.0, H / 2], [0, 0, 1]])
    cam = {"K": K, "R": R, "T": (-R @ pos).reshape(3, 1), "H": H, "W": W,
           "center": pos.reshape(3, 1)}
    return prepare_camera(cam, 1, 0.01, 1000.0)


def _models(cut_method="flat"):
    ckpt = build_checkpoint(N_ROOTS, seed=1)
    tree = dict(max_child=4, max_level=30, cut_method=cut_method)
    port = load_object("LoG.model.level_of_gaussian.LoG",
                       dict(ARGS, tree=tree), device="cpu")
    ref = LoGJax(**dict(ARGS, tree=tree))
    for m in (port, ref):
        m.load_state_dict(ckpt)
        m.set_state(enable_sh=True)
        m.eval()
    return ckpt, port, ref


def test_synth_checkpoint_layout():
    ckpt = build_checkpoint(N_ROOTS, seed=1)
    n = tree_sizes(N_ROOTS)[2]
    assert ckpt["gaussian.xyz"].shape == (n, 3)
    assert ckpt["gaussian.shs"].shape == (n, 3, 3)
    assert ckpt["tree.tree"].shape == ((n - N_ROOTS) // 4, 4)
    ip, d = ckpt["tree.index_parent"], ckpt["tree.depth"]
    # children sit one level below their parent and share its root
    kids = ip >= 0
    np.testing.assert_array_equal(d[kids], d[ip[kids]] + 1)
    np.testing.assert_array_equal(ckpt["tree.root_id"][kids],
                                  ckpt["tree.root_id"][ip[kids]])
    ni = ckpt["tree.node_index"]
    np.testing.assert_array_equal(
        ckpt["tree.tree"][ni[ni >= 0]].reshape(-1),
        np.flatnonzero(kids),
    )
    assert tree_sizes(600_000)[2] == 3_240_000


def test_load_statedict_formats(tmp_path):
    """The JAX package's pickle checkpoints and torch .pth archives."""
    ckpt = build_checkpoint(200, seed=2)
    with open(tmp_path / "a.pth", "wb") as f:
        pickle.dump(ckpt, f)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ckpt.items()}},
               tmp_path / "b.pth")
    for name in ("a.pth", "b.pth"):
        got = load_statedict(tmp_path / name)
        assert got.keys() == ckpt.keys()
        for key in ckpt:
            np.testing.assert_array_equal(got[key], ckpt[key])
    model = load_object("log_tpu.model.level_of_gaussian.LoG",
                        dict(ARGS, tree=dict(max_child=4)), device="cpu")
    assert type(model).__module__ == "log_tpu_torch.model.level_of_gaussian"


def test_state_dict_roundtrip_matches_jax():
    ckpt, port, ref = _models()
    sd, sd_j = port.state_dict(), ref.state_dict()
    for key in ckpt:
        np.testing.assert_array_equal(sd[key], ckpt[key], err_msg=key)
        np.testing.assert_array_equal(sd[key], np.asarray(sd_j[key]),
                                      err_msg=key)
    assert port.capacity == ref.capacity
    assert port.n_roots_bucket == ref.n_roots_bucket
    assert port.current_depth == ref.current_depth == 2


@pytest.mark.parametrize("cut_method", ["flat", "traverse"])
def test_cut_matches_jax(cut_method):
    _, port, ref = _models(cut_method)
    pc = _camera(0.7)
    vf = port.prepare_from_camera(pc)
    vf_j = ref.prepare_from_camera(pc)
    assert vf["counts"] == vf_j["counts"]
    assert vf["counts"][0] + vf["counts"][1] > 500
    for key in ("keep_leaf", "keep_node", "keep_mask"):
        np.testing.assert_array_equal(vf[key].numpy(), np.asarray(vf_j[key]),
                                      err_msg=key)


def test_render_fused_matches_jax():
    _, port, ref = _models()
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    for theta in (0.7, 2.3):
        pc = _camera(theta)
        out = port.render_fused(pc, bg)
        out_j = ref.render_fused(pc, bg)
        np.testing.assert_array_equal(out["counts"].numpy(),
                                      np.asarray(ref._render_counts_dev))
        assert port._render_bucket == ref._render_bucket
        assert int(out["pair_total"]) > 0
        render = out["render"].numpy()
        assert render.shape == (3, H, W) and np.isfinite(render).all()
        assert render.std() > 0.01
        np.testing.assert_allclose(render, np.asarray(out_j["render"]),
                                   atol=5e-3)
        np.testing.assert_allclose(out["alpha"].numpy(),
                                   np.asarray(out_j["alpha"]), atol=5e-3)


def test_renderer_vis_batch():
    _, port, _ = _models()
    pc = _camera(1.1)
    keys = ("camera_center", "world_view_transform", "full_proj_transform",
            "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")
    batch = {"camera": {k: np.stack([np.asarray(pc[k])] * 2) for k in keys}}
    preds = NaiveRendererAndLoss(split="demo", device="cpu").vis(batch, port)
    assert preds["render"].shape == (2, 3, H, W)
    assert preds["alpha"].shape == (2, H, W)
    direct = port.render_fused(pc, np.zeros(3, np.float32))["render"]
    want = (torch.clamp(direct, 0, 1) * 255).to(torch.uint8).numpy() / 255.0
    np.testing.assert_allclose(preds["render"][1], want, atol=1e-6)
