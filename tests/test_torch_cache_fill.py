"""The dataset cache under a process group and its atomic writes (F11).

- Under a 2-rank gloo group (parallel/launch.spawn) on a fresh scene, only
  rank 0 writes cache files (the scaled images and the info pickle) while
  the other rank waits at the group's barrier (parallel/comm.
  rank_zero_first), and both ranks read the same images. Rank 0's image
  writer is slowed, so that a rank that did not wait would find the cache
  half-filled and fill the rest itself.
- A cache file is never visible under its final name before it is whole:
  a writer that fails halfway (image_io._write_bytes patched to write half
  the bytes and raise) leaves neither the file nor its temporary name, for
  an image and for the info pickle.

The scene is written here (ring cameras, random PNGs): no renderer runs.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from log_tpu_torch.parallel.launch import spawn

VIEWS, H, W = 6, 32, 40
SCALES = [1, 2]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(root):
    from log_tpu_torch.dataset.camera_utils import write_camera
    from log_tpu_torch.dataset.synthetic import ring_cameras
    from log_tpu_torch.utils import image_io

    rng = np.random.default_rng(0)
    cameras = {}
    for i, cam in enumerate(ring_cameras(VIEWS, H, W)):
        name = f"cam/{i:04d}"
        image_io.imwrite(os.path.join(root, "images", name + ".png"),
                         rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        cameras[name] = {"K": cam["K"], "R": cam["R"], "T": cam["T"],
                         "H": H, "W": W, "dist": np.zeros((1, 5))}
    write_camera(cameras, root)


def _dataset(root):
    from log_tpu_torch.dataset.colmap import ImageDataset

    return ImageDataset(root=root, cameras="", scales=SCALES, ext=".png",
                        images="images", share_camera=True)


def _fill_rank(rank, world, device, root):
    """Every cache write this rank makes, and digests of the images it
    reads at each scale."""
    import time

    import torch.distributed as dist

    from log_tpu_torch.dataset import image_base
    from log_tpu_torch.utils import image_io

    writes = []
    imwrite, write_cache = image_io.imwrite, image_base.ImageBase.write_cache

    def slow_imwrite(name, img):
        writes.append(os.path.relpath(name, root))
        if rank == 0:
            time.sleep(0.05)
        return imwrite(name, img)

    def counted_write_cache(self, infos, name="cache"):
        writes.append(os.path.relpath(name, root))
        return write_cache(self, infos, name)

    image_io.imwrite = slow_imwrite
    image_base.ImageBase.write_cache = counted_write_cache
    dist.barrier()  # both ranks reach the dataset together
    ds = _dataset(root)
    digests = {}
    for scale in SCALES:
        ds.set_state(scale=scale)
        digests[scale] = [hashlib.sha256(np.ascontiguousarray(
            ds[i]["image"]).tobytes()).hexdigest() for i in range(len(ds))]
    return {"writes": writes, "digests": digests}


def test_rank_zero_fills_the_cache_alone(tmp_path):
    root = str(tmp_path / "scene")
    _scene(root)
    r0, r1 = spawn(_fill_rank, 2, "cpu", args=(root,), timeout_s=120)
    assert r1["writes"] == [], f"rank 1 wrote {r1['writes']}"
    images = [w for w in r0["writes"] if w.startswith("cache" + os.sep)]
    assert len(images) == VIEWS * len(SCALES)
    assert "cache.pkl" in r0["writes"]
    assert r0["digests"] == r1["digests"]
    for scale in SCALES:
        assert len(set(r0["digests"][scale])) == VIEWS
    # outside a group the dataset reads the cache rank 0 filled
    ds = _dataset(root)
    assert len(ds) == VIEWS


def test_a_failed_write_leaves_no_file(tmp_path, monkeypatch):
    from log_tpu_torch.dataset.image_base import ImageBase
    from log_tpu_torch.utils import image_io

    def half_then_fail(path, data):
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
        raise OSError("the disk filled up halfway")

    monkeypatch.setattr(image_io, "_write_bytes", half_then_fail)
    name = str(tmp_path / "cache" / "2" / "images" / "cam" / "0000.png")
    with pytest.raises(OSError, match="halfway"):
        image_io.imwrite(name, np.zeros((8, 8, 3), np.uint8))
    assert not os.path.exists(name)
    assert os.listdir(os.path.dirname(name)) == []

    base = ImageBase(cache=str(tmp_path))
    pkl = str(tmp_path / "cache.pkl")
    with pytest.raises(OSError, match="halfway"):
        base.write_cache([{"imgname": "images/cam/0000.png"}], name=pkl)
    assert not os.path.exists(pkl)
    assert sorted(os.listdir(tmp_path)) == ["cache"]
    assert base.read_cache(name=pkl) == (False, None)
