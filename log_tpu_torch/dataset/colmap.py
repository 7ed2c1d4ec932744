"""Scene dataset with the multi-scale image cache; counterpart of
log_tpu/dataset/colmap.py.

The first construction undistorts every image once per physical camera and
writes an area-downsampled copy at every scale into
``cache/<scale>/<imgname>``, and pickles the camera infos next to it; later
runs read the small cached images. The cache layout and the pickle are the
JAX package's, so a cache written by either package is read by the other.
Host numpy only: images go through utils/image_io.py; undistortion of a
camera with non-zero distortion needs cv2 and raises without it.
"""
from __future__ import annotations

import os
from os.path import join

import numpy as np

from ..parallel.comm import rank_zero_first
from ..utils import image_io
from .base import prepare_camera, rescale_camera
from .camera_utils import get_center_and_diag
from .image_base import ImageBase


def _cv2(why: str):
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{why} needs cv2, which does not import")
    return cv2


def read_undistort_rescale_write(info):
    """Fill the cache of one image: every scale that is missing."""
    missing = []
    for scale in info["scales"]:
        cachename = join(info["cache"], str(scale), info["imgname"])
        os.makedirs(os.path.dirname(cachename), exist_ok=True)
        if not os.path.exists(cachename):
            missing.append(scale)
    if not missing:
        return 0
    imgname = join(info["root"], info["imgname"])
    camera = info["camera"]
    img = image_io.imread(imgname)
    if img is None:
        raise FileNotFoundError(imgname)
    if img.shape[0] != camera["H"] or img.shape[1] != camera["W"]:
        raise ValueError(f"{imgname}: {img.shape} != {camera['H']}, "
                         f"{camera['W']}")
    if "mapx" in camera and "mapy" in camera:
        mapx, mapy = camera["mapx"], camera["mapy"]
    else:
        mapx, mapy, camera["K"] = ImageDataset.init_camera(camera)
    if mapx is not None and mapy is not None:
        cv2 = _cv2("undistorting an image")
        img = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
    for scale in missing:
        cachename = join(info["cache"], str(scale), info["imgname"])
        W = int(camera["W"] / scale)
        H = int(camera["H"] / scale)
        image_io.imwrite(cachename, image_io.resize_area(img, W, H))
    return 0


class ImageDataset(ImageBase):
    @staticmethod
    def init_camera(camera):
        """(mapx, mapy, newK) of a camera's undistortion; no maps and K
        itself where the distortion is zero."""
        width, height = camera["W"], camera["H"]
        if width == 0 or height == 0:
            raise ValueError("camera without an image size")
        dist = camera["dist"]
        if np.linalg.norm(dist) < 1e-5:
            return None, None, camera["K"].copy()
        cv2 = _cv2("a camera with non-zero distortion")
        newK, _ = cv2.getOptimalNewCameraMatrix(
            camera["K"], dist, (width, height), 0, (width, height),
            centerPrincipalPoint=True,
        )
        mapx, mapy = cv2.initUndistortRectifyMap(
            camera["K"], dist, None, newK, (width, height), 5
        )
        return mapx, mapy, newK

    def check_undis_camera(self, camname, cameras_cache, camera_undis,
                           share_camera=False):
        if share_camera:
            cache_camname = "cache"
        else:
            cache_camname = camname.split("/")[0] if "/" in camname else camname
        if cache_camname not in cameras_cache:
            print(f"[{self.__class__.__name__}] init camera {cache_camname}")
            cameras_cache[cache_camname] = self.init_camera(camera_undis)
        mapx, mapy, newK = cameras_cache[cache_camname]
        camera = {"K": newK, "mapx": mapx, "mapy": mapy}
        for key in ["R", "T", "W", "H", "center"]:
            camera[key] = camera_undis[key]
        return camera

    def __init__(
        self,
        root,
        cameras="sparse/0",
        scales=(1, 2, 4),
        scale3d=1.0,
        ext=".JPG",
        images="images",
        scale_camera_K=1.0,
        mask_ignore=None,
        foreground_mask=None,  # dir of binary masks -> item["mask"]
        pre_undis=True,
        share_camera=False,
        crop_size=(-1, -1),
        crop_ltrb=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.root = os.path.abspath(root)
        self.cameras = cameras
        self.image_dir = images
        self.ext = ext
        self.mask_ignore = mask_ignore
        self.foreground_mask = foreground_mask
        self.scales = list(scales)
        self.downsample_scale = 1
        self.scale3d = scale3d
        self.crop_size = list(crop_size)
        self.crop_ltrb = crop_ltrb
        # the crop draws are seeded from the global numpy state
        # (seed_everything), as in the JAX package
        self.rng = np.random.default_rng(np.random.randint(0, 2**31 - 1))
        print(f"[{self.__class__.__name__}] set scales: {scales}, "
              f"crop size: {crop_size}")
        if self.cache is None:
            self.cache = join(self.root, "cache")
            cachedir = self.cache
        elif self.cache.endswith(".pkl"):
            cachedir = join(self.root, self.cache.replace(".pkl", ""))
        else:
            cachedir = join(self.root, self.cache)
        self.cachedir = cachedir
        print(f"[{self.__class__.__name__}] cache dir: {self.cachedir}")
        with rank_zero_first() as lead:
            flag, infos = self.read_cache(name=cachedir + ".pkl")
            if not flag and not lead:
                raise RuntimeError(f"{cachedir}.pkl: rank 0 left the cache "
                                   f"unfilled")
            if not flag:
                cameras_loaded = self.check_cameras(
                    scale3d=scale3d, scale_camera_K=scale_camera_K)
                cameras_cache = {}
                infos = []
                for camname, camera_dis in cameras_loaded.items():
                    if pre_undis:
                        camera = self.check_undis_camera(
                            camname, cameras_cache, camera_dis, share_camera)
                    else:
                        camera = camera_dis
                    imgname = join(self.root, images, camname + ext)
                    if not os.path.exists(imgname):
                        print("Not exists:", imgname)
                        continue
                    infos.append({
                        "root": self.root,
                        "cache": cachedir,
                        "imgname": join(images, camname + ext),
                        "camera": camera.copy(),
                        "scales": list(scales),
                    })
                print(f"[{self.__class__.__name__}] undistort and scale "
                      f"{len(infos)} images ")
                for info in infos:
                    read_undistort_rescale_write(info)
                    info["camera"].pop("mapx", None)
                    info["camera"].pop("mapy", None)
                self.write_cache(infos, name=cachedir + ".pkl")
        centers = np.stack(
            [-i["camera"]["R"].T @ i["camera"]["T"] for i in infos], axis=0)
        offset, radius = get_center_and_diag(centers)
        print(f"[{self.__class__.__name__}] offset: {offset}, radius: {radius}")
        self.center = offset
        self.radius = radius
        self.current_scale = self.scales[-1]
        self.infos = infos
        print(f"[{self.__class__.__name__}] init dataset with {len(infos)} images")

    def set_state(self, scale=None, crop_size=None, downsample_scale=1,
                  namelist=None):
        if scale is not None:
            if scale not in self.scales:
                raise ValueError(f"scale {scale} not in {self.scales}")
            self.current_scale = scale
        self.downsample_scale = downsample_scale
        if crop_size is not None:
            print(f"[{self.__class__.__name__}] set crop size {crop_size}")
            self.crop_size = list(crop_size)
        print(f"[{self.__class__.__name__}] set scale {scale}, crop_size: "
              f"{self.crop_size}, downsample_scale: {downsample_scale}")

    def __len__(self):
        if self.partial_indices is None:
            return len(self.infos)
        return len(self.partial_indices)

    def crop_image(self, img, crop_size):
        sample_x = int(self.rng.integers(0, img.shape[1] - crop_size[1] + 1))
        sample_y = int(self.rng.integers(0, img.shape[0] - crop_size[0] + 1))
        return sample_x, sample_y, sample_x + crop_size[1], sample_y + crop_size[0]

    @staticmethod
    def update_crop(img, camera, l, t, r, b):
        camera["K"] = camera["K"].copy()
        img = img[t:b, l:r]
        camera["K"][0, 2] -= l
        camera["K"][1, 2] -= t
        camera["W"] = r - l
        camera["H"] = b - t
        return img, camera

    def __getitem__(self, index):
        true_index = (
            index if self.partial_indices is None else self.partial_indices[index])
        data = self.infos[true_index]
        imgname = join(self.cachedir, str(self.current_scale), data["imgname"])
        if self.read_img and os.path.exists(imgname):
            img = self.read_image_with_cache(imgname)
        else:
            img = imgname
        if self.downsample_scale != 1:
            scale = self.downsample_scale * self.current_scale
            camera = rescale_camera(data["camera"], scale)
            if self.read_img and not isinstance(img, str):
                img = image_io.resize_area(img, camera["W"], camera["H"])
        else:
            camera = rescale_camera(data["camera"], self.current_scale)
        msk = None
        if self.mask_ignore is not None:
            mskname = join(self.root, self.mask_ignore["path"],
                           data["imgname"].replace(self.ext, ".png"))
            if self.read_img and os.path.exists(mskname):
                msk = self.read_mask(mskname)
                if self.mask_ignore["type"] == "background":
                    cv2 = _cv2("mask_ignore of type background")
                    border = int(msk.shape[0] // 50) * 2 + 1
                    kernel = np.ones((border, border), np.float32)
                    msk = cv2.dilate(msk, kernel)
                    msk = 1 - msk
        if self.crop_ltrb is not None and not isinstance(img, str):
            l, t, r, b = self.crop_ltrb
            img, camera = self.update_crop(img, camera, l, t, r, b)
        elif (self.crop_size[0] > 0 and self.crop_size[1] > 0
              and not isinstance(img, str)):
            l, t, r, b = self.crop_image(img, self.crop_size)
            img, camera = self.update_crop(img, camera, l, t, r, b)
        camera = prepare_camera(camera, scale=1, znear=self.znear, zfar=self.zfar)
        ret = {
            "image": img,
            "imgname": imgname,
            "index": index,
            "true_index": true_index,
            "camera": camera,
        }
        if msk is not None:
            ret["mask_ignore"] = msk
        if self.foreground_mask is not None and self.read_img:
            # foreground mask for MaskForeground: masks/<imgname>.png,
            # brought to the current scale
            rel = os.path.relpath(
                data["imgname"].replace(self.ext, ".png"), self.image_dir)
            fname = join(self.root, self.foreground_mask, rel)
            if os.path.exists(fname):
                fmsk = self.read_mask(fname)
                if not isinstance(img, str) and fmsk.shape[:2] != img.shape[:2]:
                    fmsk = _resize_nearest(fmsk, img.shape[1], img.shape[0])
                ret["mask"] = fmsk
        ret.update(data.get("extra", {}))
        return ret


class DepthDataset(ImageDataset):
    """ImageDataset with a 16-bit monocular depth map per image (item
    "depth", float32 in [0, 1]). The map of an image is found by rewriting
    its cached path: the images dir becomes depth_dir, the current scale
    depth_scale, and ".png" is appended (cache/<depth_scale>/<depth_dir>/
    <camname><ext>.png). Where it is absent, or images are not read, the
    item holds the path instead."""

    def __init__(self, depth_scale, depth_dir="depth", **kwargs):
        super().__init__(**kwargs)
        self.depth_scale = depth_scale
        self.depth_dir = depth_dir

    def __getitem__(self, index):
        ret = super().__getitem__(index)
        depthname = ret["imgname"].replace(self.image_dir, self.depth_dir)
        depthname = depthname.replace(
            f"{os.sep}{self.current_scale}{os.sep}{self.depth_dir}",
            f"{os.sep}{self.depth_scale}{os.sep}{self.depth_dir}") + ".png"
        if self.read_img and os.path.exists(depthname):
            ret["depth"] = self.read_depth(depthname)
        else:
            ret["depth"] = depthname
        return ret


def _resize_nearest(img, width: int, height: int):
    """cv2.resize(..., INTER_NEAREST): source index floor(i * src / dst)."""
    H, W = img.shape[:2]
    ys = np.minimum((np.arange(height) * (H / height)).astype(np.int64), H - 1)
    xs = np.minimum((np.arange(width) * (W / width)).astype(np.int64), W - 1)
    return img[ys][:, xs]
