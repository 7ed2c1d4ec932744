"""Dataset base: camera list handling, the info cache and the image, depth
and mask readers; counterpart of log_tpu/dataset/image_base.py. Images are
read through utils/image_io.py."""
from __future__ import annotations

import os
import pickle
from os.path import join

import numpy as np

from ..utils import image_io


class ImageBase:
    def __init__(
        self,
        cache=None,
        cameras="",
        namelist=None,
        ignorelist=None,
        znear=0.01,
        zfar=100.0,
        offset=(0.0, 0.0, 0.0),
    ):
        self.cache = cache
        self.cameras = cameras
        if namelist is not None and isinstance(namelist, str):
            if os.path.exists(namelist):
                with open(namelist) as f:
                    namelist = f.readlines()
        self.namelist = namelist
        self.ignorelist = ignorelist
        self.offset = np.array(offset, np.float32).reshape(3, 1)
        self.use_cache = False
        self.read_img = True
        self.znear = znear
        self.zfar = zfar
        self.partial_indices = None

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def write_cache(self, infos, name="cache"):
        """Pickle the info list, under a temporary name renamed into place
        (image_io.write_bytes_atomic): a reader never sees half of it."""
        cachename = name if name.endswith(".pkl") else join(self.cache, name + ".pkl")
        if not os.path.exists(cachename):
            print("write cache to ", cachename)
            os.makedirs(os.path.dirname(cachename), exist_ok=True)
            image_io.write_bytes_atomic(cachename, pickle.dumps(infos))

    def read_cache(self, name="cache"):
        """The info list pickled by either package (files this project
        wrote only: unpickling runs code)."""
        cachename = name if name.endswith(".pkl") else join(self.cache, name + ".pkl")
        if os.path.exists(cachename):
            with open(cachename, "rb") as f:
                return True, pickle.load(f)
        return False, None

    def set_partial_indices(self, partial):
        self.partial_indices = partial
        print(f"[{self.__class__.__name__}] set partial indices {len(partial)}")

    def check_cameras(self, scale3d=-1, scale_camera_K=1.0):
        """Load the cameras, keep the namelist, drop the ignorelist, rescale
        the translations by scale3d around `offset`, scale K."""
        from .camera_utils import read_cameras

        cameras = read_cameras(join(self.root, self.cameras))
        print("Loaded {} cameras from {}".format(
            len(cameras), join(self.root, self.cameras)))
        if self.namelist is not None:
            cameras = {name.strip(): cameras[name.strip()]
                       for name in self.namelist}
        if self.ignorelist is not None:
            ignorelist = self.ignorelist
            if isinstance(ignorelist, str):
                with open(ignorelist) as f:
                    ignorelist = f.readlines()
            for name in ignorelist:
                cameras.pop(name.strip(), None)
        print(f"scale3d = {scale3d}")
        if scale3d > 0:
            for camera in cameras.values():
                center = -np.dot(camera["R"].T, camera["T"] * scale3d) - self.offset
                camera["center"] = center
                camera["T"] = -camera["R"] @ center
        if scale_camera_K != 1.0:
            for camera in cameras.values():
                camera["K"][:2, :] *= scale_camera_K
                camera["W"] = int(scale_camera_K * camera["W"])
                camera["H"] = int(scale_camera_K * camera["H"])
        return cameras

    @staticmethod
    def read_image(imgname):
        """RGB float32 in [0, 1]."""
        img = image_io.imread(imgname)
        if img is None:
            raise FileNotFoundError(imgname)
        return np.ascontiguousarray(
            (img.astype(np.float32) / 255.0)[:, :, ::-1])

    def read_image_with_cache(self, imgname):
        if self.use_cache:
            if imgname in self.cache:
                return self.cache[imgname]
            img = self.read_image(imgname)
            self.cache[imgname] = img
            return img
        return self.read_image(imgname)

    def read_depth(self, depthname):
        depth = image_io.imread(depthname, image_io.IMREAD_UNCHANGED)
        if depth is None:
            raise FileNotFoundError(depthname)
        return depth.astype(np.float32) / (2**16 - 1)

    def read_mask(self, mskname):
        msk = image_io.imread(mskname, image_io.IMREAD_UNCHANGED)
        if msk is None:
            raise FileNotFoundError(mskname)
        return msk.astype(np.float32) / 255.0

    @staticmethod
    def make_video(path, remove_image=False, fps=30):
        image_io.make_video(path, fps)

