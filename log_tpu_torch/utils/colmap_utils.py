"""COLMAP sparse models: cameras / images / points3D in .bin and .txt;
counterpart of log_tpu/utils/colmap_utils.py (format spec:
https://colmap.github.io/format.html).

Readers for both formats, `read_model`, `qvec2rotmat` / `rotmat2qvec`, and
writers: the binary ones write the same bytes as the JAX package's, the
text ones (`write_*_text`, `write_model`) the format COLMAP's text export
uses, with floats in Python's shortest round-trip form. Host numpy only.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name",
                                                     "num_params"])
Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fid, num_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(num_bytes))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read(fid, 8 * model.num_params, "d" * model.num_params)
            cameras[cam_id] = Camera(
                cam_id, model.model_name, width, height, np.array(params)
            )
    return cameras


def read_cameras_text(path):
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = Camera(
                cam_id, elems[1], int(elems[2]), int(elems[3]),
                np.array(tuple(map(float, elems[4:]))),
            )
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                ch = fid.read(1)
                if ch == b"\x00":
                    break
                name += ch
            num_points2d = _read(fid, 8, "Q")[0]
            data = _read(fid, 24 * num_points2d, "ddq" * num_points2d)
            xys = np.column_stack(
                [tuple(map(float, data[0::3])), tuple(map(float, data[1::3]))]
            )
            point3d_ids = np.array(tuple(map(int, data[2::3])))
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, point3d_ids,
            )
    return images


def read_images_text(path):
    """Two lines per image; the second (its 2D points) may be empty."""
    images = {}
    with open(path) as fid:
        lines = [l.strip() for l in fid if not l.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array(tuple(map(float, elems[1:5])))
        tvec = np.array(tuple(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.column_stack(
            [tuple(map(float, pts[0::3])), tuple(map(float, pts[1::3]))]
        ) if pts else np.zeros((0, 2))
        ids = np.array(tuple(map(int, pts[2::3]))) if pts else np.zeros((0,), int)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
        i += 2
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            track_len = _read(fid, 8, "Q")[0]
            track = _read(fid, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(tuple(map(int, track[0::2]))),
                np.array(tuple(map(int, track[1::2]))),
            )
    return points


def read_points3d_text(path):
    points = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            pid = int(elems[0])
            xyz = np.array(tuple(map(float, elems[1:4])))
            rgb = np.array(tuple(map(int, elems[4:7])))
            error = float(elems[7])
            image_ids = np.array(tuple(map(int, elems[8::2])))
            point2d_idxs = np.array(tuple(map(int, elems[9::2])))
            points[pid] = Point3D(pid, xyz, rgb, error, image_ids, point2d_idxs)
    return points


def read_model(path, ext=".bin"):
    if ext == ".bin":
        cameras = read_cameras_binary(os.path.join(path, "cameras.bin"))
        images = read_images_binary(os.path.join(path, "images.bin"))
        points3d = read_points3d_binary(os.path.join(path, "points3D.bin"))
    else:
        cameras = read_cameras_text(os.path.join(path, "cameras.txt"))
        images = read_images_text(os.path.join(path, "images.txt"))
        points3d = read_points3d_text(os.path.join(path, "points3D.txt"))
    return cameras, images, points3d


# ------------------------------------------------------------------ writers
def write_cameras_binary(cameras, path):
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_NAMES[cam.model].model_id
            fid.write(
                struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height)
            )
            for p in cam.params:
                fid.write(struct.pack("<d", float(p)))


def write_images_binary(images, path):
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(images)))
        for img in images.values():
            fid.write(
                struct.pack(
                    "<idddddddi",
                    img.id,
                    *[float(q) for q in img.qvec],
                    *[float(t) for t in img.tvec],
                    img.camera_id,
                )
            )
            fid.write(img.name.encode("utf-8") + b"\x00")
            fid.write(struct.pack("<Q", len(img.point3D_ids)))
            for xy, pid in zip(img.xys, img.point3D_ids):
                fid.write(struct.pack("<ddq", float(xy[0]), float(xy[1]), int(pid)))


def write_points3d_binary(points3d, path):
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(points3d)))
        for pt in points3d.values():
            fid.write(struct.pack("<Q", pt.id))
            fid.write(struct.pack("<ddd", *[float(x) for x in pt.xyz]))
            fid.write(struct.pack("<BBB", *[int(c) for c in pt.rgb]))
            fid.write(struct.pack("<d", float(pt.error)))
            fid.write(struct.pack("<Q", len(pt.image_ids)))
            for iid, pidx in zip(pt.image_ids, pt.point2D_idxs):
                fid.write(struct.pack("<ii", int(iid), int(pidx)))


def _fmt(values):
    return " ".join(repr(float(v)) for v in values)


def write_cameras_text(cameras, path):
    with open(path, "w") as fid:
        fid.write("# Camera list with one line of data per camera:\n"
                  "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                  f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            fid.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                      f"{_fmt(cam.params)}\n")


def write_images_text(images, path):
    with open(path, "w") as fid:
        fid.write("# Image list with two lines of data per image:\n"
                  "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                  "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                  f"# Number of images: {len(images)}\n")
        for img in images.values():
            fid.write(f"{img.id} {_fmt(img.qvec)} {_fmt(img.tvec)} "
                      f"{img.camera_id} {img.name}\n")
            fid.write(" ".join(f"{_fmt(xy)} {int(pid)}" for xy, pid
                               in zip(img.xys, img.point3D_ids)) + "\n")


def write_points3d_text(points3d, path):
    with open(path, "w") as fid:
        fid.write("# 3D point list with one line of data per point:\n"
                  "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as "
                  "(IMAGE_ID, POINT2D_IDX)\n"
                  f"# Number of points: {len(points3d)}\n")
        for pt in points3d.values():
            track = " ".join(f"{int(i)} {int(j)}" for i, j
                             in zip(pt.image_ids, pt.point2D_idxs))
            fid.write(f"{pt.id} {_fmt(pt.xyz)} "
                      f"{' '.join(str(int(c)) for c in pt.rgb)} "
                      f"{repr(float(pt.error))} {track}\n")


def write_model(cameras, images, points3d, path, ext=".bin"):
    """The three files of a sparse model into `path`, .bin or .txt."""
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(points3d, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3d_text(points3d, os.path.join(path, "points3D.txt"))
