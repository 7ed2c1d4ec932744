"""The port's COLMAP I/O and calibration tools against the JAX package's.

A random sparse model with every COLMAP camera type is written by
log_tpu.utils.colmap_utils' binary writers; the port reads it (.bin, and
.txt through its own text writers, which the JAX readers read back), and
its binary writers must give the same bytes. read_colmap, align_with_cam
and align_with_gps run on both sides on one model (the JAX tools as
subprocesses: they import no JAX) and must write equal files.
read_gps_info reads GPS EXIF that PIL wrote.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import log_tpu.dataset.camera_utils as cam_jax
import log_tpu.utils.colmap_utils as cu_jax
from log_tpu_torch.apps.calibration import (align_with_cam, align_with_gps,
                                            read_colmap, read_gps_info)
from log_tpu_torch.dataset import camera_utils
from log_tpu_torch.utils import colmap_utils as cu

REPO = Path(__file__).resolve().parent.parent
# the camera types read_colmap turns into K and dist (the others have fewer
# than the 8 parameters of its OpenCV branch, in both packages)
TOOL_MODELS = ("SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "OPENCV",
               "OPENCV_FISHEYE", "FULL_OPENCV", "THIN_PRISM_FISHEYE")


def random_model(rng, models=None, n_images=6, n_points=40):
    """(cameras, images, points3d) of the JAX package's namedtuples: one
    camera per model type, images looking at the origin from a ring (each
    with at least one 2D point), points seen by 1-5 images."""
    models = models or [m.model_name for m in cu_jax.CAMERA_MODELS]
    cameras = {}
    for i, name in enumerate(models, start=1):
        n = cu_jax.CAMERA_MODEL_NAMES[name].num_params
        params = rng.uniform(-0.1, 0.1, n)
        params[: 2 if n >= 8 else 1] = rng.uniform(300, 500)
        cameras[i] = cu_jax.Camera(i, name, 640, 480, params)
    images = {}
    for i in range(1, n_images + 1):
        a = 2 * np.pi * i / n_images
        eye = np.array([4 * np.cos(a), 4 * np.sin(a), rng.uniform(0.5, 1.5)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        k = int(rng.integers(1, 8))
        images[i] = cu_jax.Image(
            i, cu_jax.rotmat2qvec(R), -R @ eye, 1 + (i - 1) % len(cameras),
            f"img{i:03d}.jpg", rng.uniform(0, 640, (k, 2)),
            rng.integers(-1, n_points, k))
    points = {}
    for p in range(1, n_points + 1):
        t = int(rng.integers(1, 6))
        points[p] = cu_jax.Point3D(
            p, rng.normal(size=3), rng.integers(0, 256, 3), rng.uniform(0, 2),
            rng.integers(1, n_images + 1, t), rng.integers(0, 10, t))
    return cameras, images, points


def write_jax(model, path):
    os.makedirs(path, exist_ok=True)
    cameras, images, points = model
    cu_jax.write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
    cu_jax.write_images_binary(images, os.path.join(path, "images.bin"))
    cu_jax.write_points3d_binary(points, os.path.join(path, "points3D.bin"))


def assert_models_equal(a, b):
    for da, db in zip(a, b):
        assert list(da) == list(db)
        for k in da:
            ta, tb = da[k], db[k]
            assert type(ta).__name__ == type(tb).__name__
            assert ta._fields == tb._fields
            for fa, fb in zip(ta, tb):
                if isinstance(fa, np.ndarray):
                    assert np.array_equal(np.asarray(fa), np.asarray(fb)), k
                else:
                    assert fa == fb, (k, fa, fb)


@pytest.fixture(scope="module")
def model():
    return random_model(np.random.default_rng(0))


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_read_model_matches_jax(model, tmp_path, ext):
    write_jax(model, tmp_path / "jax")
    want = cu_jax.read_model(str(tmp_path / "jax"), ".bin")
    path = str(tmp_path / "jax")
    if ext == ".txt":  # the port's text writers, read by both packages
        path = str(tmp_path / "txt")
        cu.write_model(*want, path, ".txt")
        assert_models_equal(cu_jax.read_model(path, ".txt"), want)
    assert_models_equal(cu.read_model(path, ext), want)


def test_binary_writers_match_jax_bytes(model, tmp_path):
    write_jax(model, tmp_path / "jax")
    cu.write_model(*model, str(tmp_path / "port"), ".bin")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_text_reader_takes_images_without_points(tmp_path):
    cameras, images, points = random_model(np.random.default_rng(1))
    images[2] = images[2]._replace(xys=np.zeros((0, 2)),
                                   point3D_ids=np.zeros((0,), int))
    cu.write_model(cameras, images, points, str(tmp_path), ".txt")
    got = cu.read_images_text(str(tmp_path / "images.txt"))
    assert list(got) == list(images)
    assert got[2].xys.shape == (0, 2) and got[3].name == images[3].name


def test_quaternion_round_trip():
    rng = np.random.default_rng(2)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = cu.qvec2rotmat(q)
        np.testing.assert_allclose(R, cu_jax.qvec2rotmat(q), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        back = cu.rotmat2qvec(R)
        np.testing.assert_allclose(back, cu_jax.rotmat2qvec(R), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(back, q if q[0] >= 0 else -q, atol=1e-12)
    assert isinstance(cu.Image(1, q, q[:3], 1, "a", None, None).qvec2rotmat(),
                      np.ndarray)


def _run_jax_tool(tool, *args):
    proc = subprocess.run(
        [sys.executable, f"apps/calibration/{tool}.py", *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _tool_model(tmp_path, name):
    model = random_model(np.random.default_rng(3), TOOL_MODELS, n_images=7,
                         n_points=60)
    for side in ("jax", "port"):
        write_jax(model, tmp_path / name / side)
    return tmp_path / name


def assert_camera_files_equal(jax_dir, port_dir):
    want = cam_jax.read_cameras(str(jax_dir))
    got = camera_utils.read_cameras(str(port_dir))
    assert list(got) == list(want) and len(got) == 7
    for name in want:
        for key in ("K", "dist", "R", "T", "H", "W"):
            assert np.array_equal(np.asarray(got[name][key]),
                                  np.asarray(want[name][key])), (name, key)
        np.testing.assert_allclose(got[name]["Rvec"], want[name]["Rvec"],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("pca", [False, True])
def test_read_colmap_matches_jax(tmp_path, pca):
    root = _tool_model(tmp_path, "m")
    flags = ["--pca"] if pca else []
    _run_jax_tool("read_colmap", root / "jax", "--min_views", 2, *flags)
    read_colmap.main([str(root / "port"), "--min_views", "2", *flags])
    want = np.load(root / "jax" / "sparse.npz")
    got = np.load(root / "port" / "sparse.npz")
    assert want["xyz"].shape[0] > 0
    for key in ("xyz", "rgb"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    assert_camera_files_equal(root / "jax", root / "port")


def test_align_with_cam_matches_jax(tmp_path):
    root = _tool_model(tmp_path, "m")
    _run_jax_tool("align_with_cam", "--colmap_path", root / "jax",
                  "--target_path", root / "jax_out")
    align_with_cam.main(["--colmap_path", str(root / "port"),
                         "--target_path", str(root / "port_out")])
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (root / "jax_out" / name).read_bytes() == \
            (root / "port_out" / name).read_bytes(), name
    images = cu.read_images_binary(str(root / "port_out" / "images.bin"))
    centers = np.stack([-cu.qvec2rotmat(v.qvec).T @ v.tvec
                        for v in images.values()])
    # the cameras' ring now lies in a plane z = const
    assert np.ptp(centers[:, 2]) < 0.5 * np.ptp(centers[:, 0])


def test_align_with_gps_matches_jax(tmp_path):
    root = _tool_model(tmp_path, "m")
    images = cu.read_images_binary(str(root / "port" / "images.bin"))
    rng = np.random.default_rng(4)
    gps = {v.name: 100.0 * (2.5 * (-cu.qvec2rotmat(v.qvec).T @ v.tvec)
                            + [10.0, -3.0, 1.0]) + rng.normal(0, 1, 3)
           for v in images.values()}
    np.save(root / "gps.npy", gps, allow_pickle=True)
    _run_jax_tool("align_with_gps", "--gps_path", root / "gps.npy",
                  "--colmap_path", root / "jax", "--output_colmap_path",
                  root / "jax_out")
    align_with_gps.main(["--gps_path", str(root / "gps.npy"),
                         "--colmap_path", str(root / "port"),
                         "--output_colmap_path", str(root / "port_out")])
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (root / "jax_out" / name).read_bytes() == \
            (root / "port_out" / name).read_bytes(), name
    centers = [-cu.qvec2rotmat(v.qvec).T @ v.tvec for v in images.values()]
    scale, _, _ = align_with_gps.umeyama_similarity(
        np.stack(centers),
        np.stack([gps[v.name] / 100.0 for v in images.values()]))
    assert abs(scale - 2.5) < 0.05


def test_read_gps_info(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    fixes = {"a.jpg": ((30, 15, 36.0), "N", (120, 0, 0.0), "E", 12.5),
             "b.jpg": ((30, 15, 37.8), "N", (120, 0, 1.2), "E", 14.0),
             "c.jpg": ((30, 15, 36.9), "S", (120, 0, 0.6), "W", 10.0)}
    for name, (lat, lat_ref, lon, lon_ref, alt) in fixes.items():
        exif = Image.Exif()
        exif[0x8825] = {1: lat_ref, 2: lat, 3: lon_ref, 4: lon, 6: alt}
        Image.new("RGB", (8, 8), (128, 64, 32)).save(img_dir / name,
                                                     exif=exif)
    Image.new("RGB", (8, 8)).save(img_dir / "nogps.jpg")
    lat, lon, alt = read_gps_info.read_exif_gps(str(img_dir / "c.jpg"))
    assert lat == pytest.approx(-(30 + 15 / 60 + 36.9 / 3600))
    assert lon == pytest.approx(-(120 + 0.6 / 3600)) and alt == 10.0
    out = tmp_path / "gps.npy"
    read_gps_info.main([str(img_dir), "--out", str(out)])
    got = np.load(out, allow_pickle=True).tolist()
    assert sorted(got) == ["a.jpg", "b.jpg", "c.jpg"]
    # b lies 1.8 s of latitude (~55.7 m) north and 1.2 s of longitude east
    # of a, and 1.5 m higher
    d = got["b.jpg"] - got["a.jpg"]
    assert d[1] == pytest.approx(np.deg2rad(1.8 / 3600) * 6378137.0)
    assert d[2] == pytest.approx(1.5)
