"""The port's host data layer against OpenCV and the JAX package: camera
files, the PNG codec, the area resize, ImageDataset and its cache, the
sampler, the demo paths and the synthetic scene generator."""
import os
import shutil
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from log_tpu.dataset import camera_utils as cam_jax
from log_tpu.dataset import colmap as colmap_jax
from log_tpu.dataset import demo as demo_jax
from log_tpu.dataset import overlook as overlook_jax
from log_tpu.dataset.synthetic import SyntheticDataset as SyntheticJax
from log_tpu.utils import sampler as sampler_jax
from log_tpu_torch.dataset import camera_utils, colmap, demo, overlook
from log_tpu_torch.dataset.synthetic import SyntheticDataset
from log_tpu_torch.utils import image_io, sampler

H, W = 64, 80
CAM_KEYS = ("K", "R", "T", "dist", "H", "W", "center", "Rvec")


def _write_scene(root, ext, ds):
    """The JAX package's scene writer (tests/test_datasets.py) in `ext`."""
    os.makedirs(os.path.join(root, "images", "cam"), exist_ok=True)
    cameras = {}
    for i, cam in enumerate(ds.cameras):
        name = f"cam/{i:04d}"
        img = (np.clip(ds.images[i], 0, 1)[:, :, ::-1] * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "images", name + ext), img)
        cameras[name] = {"K": cam["K"], "R": cam["R"],
                         "T": cam["T"].reshape(3, 1), "H": H, "W": W,
                         "dist": np.zeros((1, 5))}
    cam_jax.write_camera(cameras, root)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two copies of a 4-view 64x80 scene, one in .jpg and one in .png."""
    ds = SyntheticJax(n_gaussians=50, n_views=4, H=H, W=W, seed=2)
    out = {}
    for ext in (".jpg", ".png"):
        root = str(tmp_path_factory.mktemp("scene" + ext[1:]))
        _write_scene(root, ext, ds)
        out[ext] = root
    return out


# ------------------------------------------------------------- readers
def test_camera_reader_matches_cv2(scenes):
    want = cam_jax.read_cameras(scenes[".png"])
    got = camera_utils.read_cameras(scenes[".png"])
    assert list(got) == list(want)
    for name in want:
        for key in CAM_KEYS:
            a, b = np.asarray(got[name][key]), np.asarray(want[name][key])
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, key)


def test_camera_reader_reads_opencv_files(tmp_path):
    """A file cv2.FileStorage wrote itself: matrices whose data spans
    lines, float32 matrices, ints and a names list."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "cv.yml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    mats = {"K_01": rng.normal(size=(3, 3)) * 100,
            "dist_01": rng.normal(size=(1, 5)),
            "R_01": rng.normal(size=(3, 1)),
            "F": rng.normal(size=(2, 7)).astype(np.float32)}
    for key, val in mats.items():
        fs.write(key, val)
    fs.write("H_01", 64)
    fs.write("names", ["01", "b"])
    fs.release()
    with open(path) as f:
        assert "\n       " in f.read()  # data over several lines
    got = camera_utils.FileStorage(path)
    want = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    for key in mats:
        a, b = got.read(key), want.getNode(key).mat()
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert got.read("H_01", dt="int") == 64
    assert got.read("names", dt="list") == ["01", "b"]
    R = camera_utils.rodrigues(got.read("R_01"))
    assert np.array_equal(R, cv2.Rodrigues(want.getNode("R_01").mat())[0])
    want.release()


def test_rodrigues_matches_cv2():
    rng = np.random.default_rng(1)
    for scale in (1e-3, 1.0, 3.0):
        for _ in range(50):
            r = rng.normal(size=(3, 1)) * scale
            R = cv2.Rodrigues(r)[0]
            assert np.array_equal(camera_utils.rodrigues(r), R)
            np.testing.assert_allclose(camera_utils.rodrigues_inv(R),
                                       cv2.Rodrigues(R)[0], rtol=0, atol=1e-12)


def _random_image(kind, rng, h=37, w=53):
    if kind == "gray16":
        return np.cumsum(rng.integers(0, 900, (h, w)), axis=1).astype(np.uint16)
    c = {"rgb": 3, "gray": 1, "rgba": 4}[kind]
    smooth = np.cumsum(rng.integers(-4, 5, (h, w, c)), axis=1) + 128
    img = np.clip(smooth, 0, 255).astype(np.uint8)
    img[::7] = rng.integers(0, 256, img[::7].shape)  # noisy rows too
    return img[:, :, 0] if c == 1 else img


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "gray16"])
def test_png_codec_matches_cv2(kind, tmp_path):
    """cv2 reads what the port writes, the port reads what cv2 writes, bit
    for bit, unchanged and (8-bit) as BGR."""
    img = _random_image(kind, np.random.default_rng(len(kind)))
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv.png")
    assert image_io.imwrite(ours, img) == ours
    cv2.imwrite(theirs, img)
    for path in (ours, theirs):
        a = image_io.imread(path, image_io.IMREAD_UNCHANGED)
        b = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
        assert np.array_equal(a, img)
        if kind != "gray16":
            assert np.array_equal(image_io.imread(path), cv2.imread(path))


def _png_with_filter(img, ftype):
    """An RGB PNG whose rows all use the Average (3) or Paeth (4) filter."""
    h, w, _ = img.shape
    rows = img.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        raw.append(ftype)
        for x in range(w * 3):
            a = rows[y, x - 3] if x >= 3 else 0
            b = rows[y - 1, x] if y else 0
            c = rows[y - 1, x - 3] if (x >= 3 and y) else 0
            if ftype == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            raw.append((rows[y, x] - pred) & 0xFF)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [3, 4])
def test_png_decodes_average_and_paeth(ftype, tmp_path):
    img = _random_image("rgb", np.random.default_rng(ftype), 9, 11)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filter(img, ftype))
    assert np.array_equal(image_io.png_decode(path.read_bytes()), img)
    assert np.array_equal(image_io.imread(str(path))[:, :, ::-1],
                          cv2.imread(str(path))[:, :, ::-1])


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_area_matches_cv2(factor):
    """Integer-factor INTER_AREA: uint8 exactly, float32 to 1 ulp of the
    mean."""
    rng = np.random.default_rng(factor)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    size = (W // factor, H // factor)
    want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    assert np.array_equal(image_io.resize_area(img, *size), want)
    imgf = rng.random((H, W, 3)).astype(np.float32)
    want = cv2.resize(imgf, size, interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(image_io.resize_area(imgf, *size), want,
                               rtol=0, atol=2e-7)


@pytest.mark.parametrize("blocked", [("cv2",), ("cv2", "PIL")])
def test_jpeg_without_cv2(blocked, tmp_path, monkeypatch, capsys):
    """Without cv2, PIL reads and writes JPEGs bit for bit as cv2 does
    (quality 95, both on libjpeg-turbo); without either, reading a JPEG
    raises and writing one writes the same pixels as a PNG."""
    img = _random_image("rgb", np.random.default_rng(7))
    theirs = str(tmp_path / "cv.jpg")
    cv2.imwrite(theirs, img)
    want_read = cv2.imread(theirs)
    for name in blocked + (("PIL.Image",) if "PIL" in blocked else ()):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(image_io, "_warned_no_jpeg", [])
    ours = str(tmp_path / "ours.jpg")
    if "PIL" not in blocked:
        assert image_io._jpeg_backend() == "PIL"
        assert np.array_equal(image_io.imread(theirs), want_read)
        assert image_io.imwrite(ours, img) == ours
        assert np.array_equal(cv2.imread(ours), want_read)
        return
    assert image_io._jpeg_backend() is None
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        image_io.imread(theirs)
    written = image_io.imwrite(ours, img)
    assert written == str(tmp_path / "ours.png")
    assert "no JPEG encoder" in capsys.readouterr().out
    assert np.array_equal(image_io.imread(written), img)


# --------------------------------------------------- datasets vs the JAX side
def _dataset(mod, root, ext, **kw):
    return mod.ImageDataset(root=root, cameras="", scales=[1, 2, 4],
                            znear=0.01, zfar=100.0, scale3d=1.0, ext=ext,
                            share_camera=True, **kw)


def _items_equal(a_ds, b_ds):
    for scale in (1, 2, 4):
        a_ds.set_state(scale=scale)
        b_ds.set_state(scale=scale)
        assert len(a_ds) == len(b_ds)
        for i in range(len(a_ds)):
            a, b = a_ds[i], b_ds[i]
            assert a["image"].shape == (H // scale, W // scale, 3)
            assert a["image"].dtype == b["image"].dtype
            assert np.array_equal(a["image"], b["image"]), (scale, i)
            assert a["imgname"].split(os.sep + "cache" + os.sep)[1] == \
                b["imgname"].split(os.sep + "cache" + os.sep)[1]
            assert set(a["camera"]) == set(b["camera"])
            for key, val in b["camera"].items():
                got = np.asarray(a["camera"][key])
                assert got.dtype == np.asarray(val).dtype, key
                assert np.array_equal(got, val), (scale, i, key)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_image_dataset_matches_jax(scenes, ext, tmp_path):
    """Items at every scale: cameras exact in float32, images exact (the
    JPEG cache through cv2 on both sides). The JAX package fills the cache
    of one copy and the port that of another; then each reads the other's."""
    ours = str(tmp_path / "ours")
    shutil.copytree(scenes[ext], ours)
    theirs = str(tmp_path / "theirs")
    shutil.copytree(scenes[ext], theirs)
    jax_ds = _dataset(colmap_jax, theirs, ext)
    port_ds = _dataset(colmap, ours, ext)
    assert os.path.exists(os.path.join(ours, "cache.pkl"))
    for scale in (1, 2, 4):
        names = sorted(os.listdir(os.path.join(ours, "cache", str(scale),
                                               "images", "cam")))
        assert names == [f"{i:04d}{ext}" for i in range(4)]
    _items_equal(port_ds, jax_ds)
    # a cache written by either package is read by the other
    _items_equal(_dataset(colmap, theirs, ext), jax_ds)
    _items_equal(port_ds, _dataset(colmap_jax, ours, ext))


def test_image_dataset_crops_and_partial(scenes, tmp_path):
    """Random crops draw from the global numpy seed as in the JAX
    package; partial indices and read_img=False give names and cameras."""
    root = str(tmp_path / "s")
    shutil.copytree(scenes[".png"], root)
    items = []
    for mod in (colmap_jax, colmap):
        np.random.seed(5)
        ds = _dataset(mod, root, ".png", crop_size=[32, 48])
        ds.set_state(scale=1)
        items.append([ds[i] for i in (0, 3, 1)])
        ds.set_partial_indices([2, 0])
        ds.read_img = False
        items[-1].append(ds[0])
    for a, b in zip(*items):
        if isinstance(b["image"], str):
            assert a["image"] == b["image"] and a["true_index"] == 2
        else:
            assert np.array_equal(a["image"], b["image"])
        for key, val in b["camera"].items():
            assert np.array_equal(a["camera"][key], val), key


def test_sampler_order_matches_jax():
    ds = list(range(7))
    for seed in (0, 123, 2**31 - 1):
        a = list(sampler.IterationBasedSampler(ds, 50, seed=seed))
        b = list(sampler_jax.IterationBasedSampler(ds, 50, seed=seed))
        assert a == b
    loader = sampler.DataLoader([{"i": i, "x": np.full(2, i)} for i in ds],
                                sampler=sampler.IndexSampler(ds, [3, 1, 4]),
                                batch_size=2)
    batches = list(loader)
    assert [b["i"].tolist() for b in batches] == [[3, 1], [4]]
    assert batches[0]["x"].shape == (2, 2)


def test_loader_raises_worker_errors():
    class Bad:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(sampler.DataLoader(Bad(), batch_size=1))


def _cams_close(a_ds, b_ds, atol):
    assert len(a_ds) == len(b_ds)
    for i in range(len(b_ds)):
        a, b = a_ds[i], b_ds[i]
        for key, val in b["camera"].items():
            np.testing.assert_allclose(np.asarray(a["camera"][key], np.float64),
                                       np.asarray(val, np.float64), rtol=0,
                                       atol=atol, err_msg=f"{i} {key}")
        assert a.get("model_state") == b.get("model_state")


def test_demo_paths_match_jax(scenes):
    """InterpolatePath within 1e-9 (before the float32 cast of the camera
    dict), and the other paths."""
    root = scenes[".png"]
    subs = ["cam/0000", "cam/0001", "cam/0002", "cam/0003", "cam/0000"]
    kw = dict(cameras=root, steps=12, scale=2, subs=subs)
    a, b = demo.InterpolatePath(**kw), demo_jax.InterpolatePath(**kw)
    for ia, ib in zip(a.infos, b.infos):
        for key in ("R", "T", "K", "center"):
            np.testing.assert_allclose(ia["camera"][key], ib["camera"][key],
                                       rtol=0, atol=1e-9)
    _cams_close(a, b, 0)
    pairs = [
        (demo.DemoDataset(size=64, ranges=[0, 360, 5]),
         demo_jax.DemoDataset(size=64, ranges=[0, 360, 5])),
        (demo.ZoomInOut(cameras=root, sub="cam/0001", zranges=[-1.0, 1.0],
                        steps=5),
         demo_jax.ZoomInOut(cameras=root, sub="cam/0001", zranges=[-1.0, 1.0],
                            steps=5)),
        (demo.ShowLevel(cameras=root, sub="cam/0000", steps=4, mode="pixel"),
         demo_jax.ShowLevel(cameras=root, sub="cam/0000", steps=4,
                            mode="pixel")),
        (overlook.OverlookByScale(focal=100.0, shape=[64, 48], rotate_x=30.0,
                                  ground_height=0.0, step=3, scales=[0.5, 2.0]),
         overlook_jax.OverlookByScale(focal=100.0, shape=[64, 48],
                                      rotate_x=30.0, ground_height=0.0,
                                      step=3, scales=[0.5, 2.0])),
        (overlook.LookAt(K=[[100, 0, 32], [0, 100, 24], [0, 0, 1]], H=48,
                         W=64, scale=1, lookat=[0, 0, 0], radius=[2.0, 4.0, 5],
                         angle=30.0, ranges=[0, 360, 5]),
         overlook_jax.LookAt(K=[[100, 0, 32], [0, 100, 24], [0, 0, 1]], H=48,
                             W=64, scale=1, lookat=[0, 0, 0],
                             radius=[2.0, 4.0, 5], angle=30.0,
                             ranges=[0, 360, 5])),
    ]
    for ours, theirs in pairs:
        _cams_close(ours, theirs, 1e-6)
    cams = camera_utils.read_cameras(root)
    new = camera_utils.interp_cameras(cams, ["cam/0000", "cam/0002"], step=4)
    old = cam_jax.interp_cameras(cam_jax.read_cameras(root),
                                 ["cam/0000", "cam/0002"], step=4)
    assert list(new) == list(old)
    for k in old:
        for key in ("K", "R", "T"):
            np.testing.assert_allclose(new[k][key], old[k][key], atol=1e-12)


def test_synthetic_images_match_jax():
    """The port's generator (oracle on the CPU here) against the JAX one
    from the same seed: 8-bit images at most 1/255 apart, mean under
    1e-4."""
    kw = dict(n_gaussians=300, n_views=3, H=48, W=64, seed=0)
    ours, theirs = SyntheticDataset(device="cpu", **kw), SyntheticJax(**kw)
    for key, val in theirs.scene.items():
        assert np.array_equal(ours.scene[key], val), key
    for a, b in zip(ours.images, theirs.images):
        q = [(np.clip(x, 0, 1) * 255).astype(np.uint8).astype(np.int32)
             for x in (a, b)]
        diff = np.abs(q[0] - q[1]) / 255.0
        assert diff.max() <= 1 / 255 + 1e-9 and diff.mean() < 1e-4
    np.testing.assert_array_equal(ours.noisy_pointcloud()["xyz"],
                                  theirs.noisy_pointcloud()["xyz"])


def test_metrics_match_jax():
    from log_tpu.utils import metric as metric_jax
    from log_tpu_torch.utils import metric

    rng = np.random.default_rng(4)
    a, b = rng.random((2, 3, 8, 9)), rng.random((2, 3, 8, 9))
    assert metric.psnr(a, b) == metric_jax.psnr(a, b)
    np.testing.assert_array_equal(metric.mse(a, b), metric_jax.mse(a, b))
    assert metric.psnr(torch.from_numpy(a), b) == metric_jax.psnr(a, b)


def test_ssim_np_and_fov2focal_match_jax():
    from log_tpu.utils import camera as camera_jax
    from log_tpu.utils import metric as metric_jax
    from log_tpu_torch.utils import camera, metric

    rng = np.random.default_rng(5)
    a = rng.random((3, 24, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = metric_jax.ssim_np(a, b)
    assert abs(metric.ssim_np(a, b) - want) < 1e-6
    assert abs(metric.ssim_np(torch.from_numpy(a), b) - want) < 1e-6
    assert metric.ssim_np(a, a) == pytest.approx(1.0, abs=1e-6)
    for fov, px in ((0.3, 64), (1.2, 1920), (2.0, 1088)):
        assert camera.fov2focal(fov, px) == camera_jax.fov2focal(fov, px)
        assert camera.focal2fov(camera.fov2focal(fov, px), px) == \
            pytest.approx(fov, rel=1e-12)
