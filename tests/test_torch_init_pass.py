"""The port's model growth from a point cloud against log_tpu on the CPU:
the PLY reader and writer, the KNN that sets the initial scales,
GaussianPoint(init_ply=...) and the init pass (init_view, at_init_final).

Limits: the point-cloud arrays equal; the KNN's mean squared distances to
1e-6 relative (the two libraries are built with different flags, so
contracted multiply-adds may round differently); the init pass's
radius3d_min, lifted scales and radius3d_max to 1e-6.
"""
import math

import numpy as np
import pytest
import torch

from log_tpu.model.gaussian import GaussianPoint as GaussianPointJax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.native import knn_mean_sq_dist as knn_jax
from log_tpu.utils.file import read_ply as read_ply_jax
from log_tpu_torch import native
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.model.gaussian import GaussianPoint
from log_tpu_torch.model.level_of_gaussian import LoG
from log_tpu_torch.utils import file as port_file

KEYS = ("scaling", "colors", "xyz", "opacity", "rotation", "shs")


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                    rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return xyz, colors


@pytest.fixture
def ply(tmp_path):
    xyz, colors = _cloud()
    path = str(tmp_path / "points.ply")
    port_file.write_ply(path, xyz, colors)
    return path, xyz, colors


def test_ply_round_trip_matches_jax(ply):
    path, xyz, colors = ply
    got = port_file.read_ply(path)
    want = read_ply_jax(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], xyz.astype(np.float64))
    np.testing.assert_array_equal(
        got[1], (np.clip(colors, 0, 1) * 255).astype(np.uint8) / 255.0)


def test_knn_matches_jax():
    """The port's native KNN against log_tpu's on the same points, and its
    scipy fallback against both."""
    xyz, _ = _cloud(2000, seed=5)
    got = native.knn_mean_sq_dist(xyz, k=3)
    want = knn_jax(xyz, k=3)
    assert got is not None, native.build_error()
    if want is None:
        pytest.skip("log_tpu's native KNN did not build here")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    from scipy.spatial import cKDTree

    d, _ = cKDTree(xyz).query(xyz, k=4)
    np.testing.assert_allclose(got, np.mean(d[:, 1:] ** 2, axis=1),
                               rtol=1e-4, atol=1e-8)


def test_knn_logs_its_path(capsys, monkeypatch):
    xyz, _ = _cloud(50, seed=6)
    native_out = port_file.knn_mean_sq_dist(xyz)
    assert "[knn] native grid hash" in capsys.readouterr().out
    monkeypatch.setattr(native, "knn_mean_sq_dist", lambda *a, **k: None)
    fallback = port_file.knn_mean_sq_dist(xyz)
    assert "scipy cKDTree" in capsys.readouterr().out
    np.testing.assert_allclose(fallback, native_out, rtol=1e-4)


@pytest.mark.parametrize("ground", [False, True])
def test_gaussian_from_ply_matches_jax(ply, ground):
    path, _, _ = ply
    init_ply = {"filename": path, "init_opacity": 0.1}
    if ground:
        init_ply.update(height=-0.1, init_step=0.5)
    port = GaussianPoint(init_ply=dict(init_ply), sh_degree=1, device="cpu")
    ref = GaussianPointJax(init_ply=dict(init_ply), sh_degree=1)
    assert port.keys == ref.keys == list(KEYS)
    assert port.num_points == ref.num_points > 300 * ground
    assert port.capacity == ref.capacity
    for key in KEYS:
        got = port.get(key).numpy()
        want = np.asarray(ref.get(key))
        if key == "scaling":  # from the KNN (see test_knn_matches_jax)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    # one scale on all three axes of a cloud point, as the reference's
    np.testing.assert_array_equal(port.get("scaling")[:300, 0],
                                  port.get("scaling")[:300, 2])


def test_gaussian_items_and_alive_mask_match_jax(ply):
    path, _, _ = ply
    init_ply = {"filename": path, "init_opacity": 0.1}
    port = GaussianPoint(init_ply=dict(init_ply), sh_degree=1, device="cpu")
    ref = GaussianPointJax(init_ply=dict(init_ply), sh_degree=1)
    got, want = list(port.items()), list(ref.items())
    assert [k for k, _ in got] == [k for k, _ in want] == list(KEYS)
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape
    mask = port.alive_mask
    assert mask.dtype == torch.bool and mask.shape == (port.capacity,)
    assert port.capacity > port.num_points == int(mask.sum())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref.alive_mask))


# ------------------------------------------------------------------ init pass
MODEL_ARGS = {
    "use_view_correction": True,
    "gaussian": {"xyz_scale": 1.5, "sh_degree": 1},
    "optimizer": {"optimize_keys": list(KEYS), "opt_all_levels": True,
                  "lr_dict": {"xyz": 0.00016, "colors": 0.0025,
                              "max_steps": 600}},
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {},
}


def _view(theta, h=48, w=96, focal=20.0):
    pos = np.array([7 * math.cos(theta), 7 * math.sin(theta), 4.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    return prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                           "H": h, "W": w, "center": pos.reshape(3, 1)},
                          1, 0.01, 100.0)


def test_init_pass_matches_jax(ply):
    path, _, _ = ply
    args = dict(MODEL_ARGS, gaussian=dict(
        MODEL_ARGS["gaussian"], init_ply={"filename": path,
                                          "init_opacity": 0.1}))
    port = LoG(**args, device="cpu")
    ref = LoGJax(**args)
    # the same starting scales in both (the KNN may differ in the last bit)
    arrays = {k: np.array(v)[: ref.num_points]
              for k, v in ref.gaussian.params().items()}
    port.gaussian.set_numpy(arrays)
    n = ref.num_points
    for m in (port, ref):
        m.at_init_start()
        for theta in (0.3, 1.9, 4.0):
            m.clear()
            m.init_view(_view(theta))
        m.at_init_final()
    assert port.num_views == ref.num_views == 3
    r3min = port.counter.data["radius3d_min"][:n].numpy()
    np.testing.assert_allclose(
        r3min, np.asarray(ref.counter.data["radius3d_min"])[:n], rtol=1e-6,
        atol=1e-6)
    assert (r3min < 1.0).mean() > 0.5  # most points were seen
    np.testing.assert_allclose(port.gaussian.get("scaling")[:n].numpy(),
                               np.asarray(ref.gaussian.get("scaling"))[:n],
                               rtol=1e-6, atol=1e-6)
    lifted = port.gaussian.get("scaling")[:n].numpy() > arrays["scaling"]
    assert lifted.any()
    np.testing.assert_allclose(port.counter.data["radius3d_max"].numpy(),
                               np.asarray(ref.counter.data["radius3d_max"]),
                               rtol=1e-6, atol=1e-6)
    assert float(port.counter.data["radius3d_max"][0]) == pytest.approx(0.3)
    assert port.view_correction.values.shape == (3, 3)
    assert torch.equal(port._leaf_opt_dev,
                       torch.zeros(port.capacity, dtype=torch.bool))
