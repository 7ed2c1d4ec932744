"""Camera files (intri.yml / extri.yml) and camera helpers; counterpart of
log_tpu/dataset/camera_utils.py.

The files are OpenCV FileStorage YAML (`%YAML:1.0`): K_/dist_/H_/W_ in
intri.yml, R_ (a Rodrigues vector), Rot_ and T_ in extri.yml, and a `names`
list in both. The port parses them itself (`!!opencv-matrix` nodes with
rows / cols / dt / data, where data may span lines as OpenCV writes it, plus
string lists and ints) and writes the same layout as the JAX package, so the
files round-trip with OpenCV. `rodrigues` / `rodrigues_inv` are OpenCV's
cv::Rodrigues in numpy.
"""
from __future__ import annotations

import math
import os
from os.path import join

import numpy as np

_DTYPES = {"d": np.float64, "f": np.float32, "i": np.int32, "u": np.uint8,
           "c": np.int8, "w": np.uint16, "s": np.int16}


def _parse_scalar(text: str):
    text = text.strip()
    if text[:1] in ("'", '"') and text[-1:] == text[:1]:
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def _split_key(line: str):
    """(key, rest) of 'key: rest' / 'key:'. Keys may hold '/' and ':' not
    followed by a space (OpenCV writes 'K_cam/0000: ...')."""
    for i, ch in enumerate(line):
        if ch == ":" and (i + 1 == len(line) or line[i + 1] == " "):
            return line[:i].strip(), line[i + 1:].strip()
    return None, None


def parse_opencv_yaml(text: str) -> dict:
    """Top-level nodes of an OpenCV FileStorage YAML file: matrices as
    numpy arrays of their dt, sequences as lists, scalars as int / float /
    str."""
    lines = [ln.rstrip("\r").rstrip() for ln in text.splitlines()]
    lines = [ln for ln in lines
             if ln.strip() and not ln.startswith("%") and ln.strip() != "---"]
    out, i = {}, 0
    while i < len(lines):
        key, rest = _split_key(lines[i])
        if key is None or lines[i][:1] == " ":
            raise ValueError(f"cannot parse camera file line: {lines[i]!r}")
        i += 1
        body = []
        while i < len(lines) and lines[i][:1] in (" ", "-"):
            body.append(lines[i].strip())
            i += 1
        if rest.startswith("!!opencv-matrix"):
            out[key] = _parse_matrix(body, key)
        elif rest == "":
            out[key] = [_parse_scalar(b[1:]) for b in body
                        if b.startswith("-")]
        else:
            out[key] = _parse_scalar(rest)
    return out


def _parse_matrix(body, key):
    fields, data = {}, None
    j = 0
    while j < len(body):
        k, v = _split_key(body[j])
        j += 1
        if k == "data":
            while "]" not in v:
                v += " " + body[j]
                j += 1
            data = [float(x) for x in v.strip()[1:v.rindex("]")].split(",")
                    if x.strip()]
        else:
            fields[k] = v
    rows, cols = int(fields["rows"]), int(fields["cols"])
    dtype = _DTYPES[fields.get("dt", "d")[0]]
    if data is None or len(data) != rows * cols:
        raise ValueError(f"{key}: expected {rows}x{cols} values")
    return np.asarray(data, np.float64).astype(dtype).reshape(rows, cols)


class FileStorage:
    """Read (the OpenCV layout, parsed in numpy) or write one camera
    file."""

    def __init__(self, filename, is_write=False):
        self.is_write = is_write
        if is_write:
            os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
            self.fs = open(filename, "w")
            self.fs.write("%YAML:1.0\r\n---\r\n")
        else:
            if not os.path.exists(filename):
                raise FileNotFoundError(filename)
            with open(filename) as f:
                self.nodes = parse_opencv_yaml(f.read())

    def close(self):
        if self.is_write and not self.fs.closed:
            self.fs.close()

    def __del__(self):
        if getattr(self, "is_write", False):
            self.close()

    def _write(self, out):
        self.fs.write(out + "\r\n")

    def write(self, key, value, dt="mat"):
        if dt == "mat":
            value = np.asarray(value)
            self._write(f"{key}: !!opencv-matrix")
            self._write(f"  rows: {value.shape[0]}")
            self._write(f"  cols: {value.shape[1]}")
            self._write("  dt: d")
            data = ", ".join(f"{v:.6f}" for v in value.reshape(-1))
            self._write(f"  data: [{data}]")
        elif dt == "list":
            self._write(f"{key}:")
            for elem in value:
                self._write(f'  - "{elem}"')
        elif dt == "int":
            self._write(f"{key}: {value}")

    def read(self, key, dt="mat"):
        node = self.nodes.get(key)
        if dt == "mat":
            return node if isinstance(node, np.ndarray) else None
        if dt == "list":
            if node is None:
                return []
            vals = [str(int(v)) if isinstance(v, (int, float)) else v
                    for v in node]
            return [v for v in vals if v != "none"]
        if dt == "int":
            return None if node is None else int(node)
        raise NotImplementedError(dt)


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a Rodrigues vector (cv::Rodrigues)."""
    x, y, z = (float(v) for v in np.asarray(rvec, np.float64).reshape(3))
    theta = math.sqrt(x * x + y * y + z * z)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    it = 1.0 / theta
    r = np.array([x * it, y * it, z * it])
    rx, ry, rz = r
    r_x = np.array([[0.0, -rz, ry], [rz, 0.0, -rx], [-ry, rx, 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * r_x


def rodrigues_inv(R) -> np.ndarray:
    """The (3, 1) Rodrigues vector of a rotation matrix (cv::Rodrigues:
    the nearest rotation by SVD first)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = np.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros((3, 1))
        t = (R[0, 0] + 1) * 0.5
        rx = np.sqrt(max(t, 0.0))
        t = (R[1, 1] + 1) * 0.5
        ry = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        t = (R[2, 2] + 1) * 0.5
        rz = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if abs(rx) < abs(ry) and abs(rx) < abs(rz) and \
                (R[1, 2] > 0) != (ry * rz > 0):
            rz = -rz
        v = np.array([rx, ry, rz])
        return (v * (theta / np.sqrt(v @ v))).reshape(3, 1)
    vth = 1.0 / (2.0 * s) * theta
    return (np.array([rx, ry, rz]) * vth).reshape(3, 1)


def read_camera(intri_name, extri_name, cam_names=()):
    intri = FileStorage(intri_name)
    extri = FileStorage(extri_name)
    cams = {}
    names = intri.read("names", dt="list")
    for cam in names:
        c = {}
        c["K"] = intri.read(f"K_{cam}")
        c["invK"] = np.linalg.inv(c["K"])
        H = intri.read(f"H_{cam}", dt="int")
        W = intri.read(f"W_{cam}", dt="int")
        if H is None or W is None:
            print(f"[camera] no H or W for {cam}")
            H, W = -1, -1
        c["H"], c["W"] = H, W
        rvec = extri.read(f"R_{cam}")
        tvec = extri.read(f"T_{cam}")
        if rvec is None:
            raise KeyError(f"R_{cam} missing in {extri_name}")
        R = rodrigues(rvec)
        c["RT"] = np.hstack((R, tvec))
        c["R"] = R
        c["Rvec"] = rvec
        c["T"] = tvec
        c["center"] = -R.T @ tvec
        c["P"] = c["K"] @ c["RT"]
        c["dist"] = intri.read(f"dist_{cam}")
        if c["dist"] is None:
            c["dist"] = intri.read(f"D_{cam}")
            if c["dist"] is None:
                print(f"[camera] no dist for {cam}")
        cams[cam] = c
    cams["basenames"] = names
    return cams


def read_cameras(path, intri="intri.yml", extri="extri.yml", subs=()):
    if os.path.isfile(path):
        path = os.path.dirname(path)
    cameras = read_camera(join(path, intri), join(path, extri))
    cameras.pop("basenames")
    if len(subs) > 0:
        cameras = {key: cameras[key] for key in subs}
    return cameras


def write_camera(camera, path):
    intri = FileStorage(join(path, "intri.yml"), True)
    extri = FileStorage(join(path, "extri.yml"), True)
    camnames = [k.split(".")[0] for k in camera.keys() if k != "basenames"]
    intri.write("names", camnames, "list")
    extri.write("names", camnames, "list")
    for key_, val in camera.items():
        if key_ == "basenames":
            continue
        key = key_.split(".")[0]
        intri.write(f"K_{key}", val["K"])
        intri.write(f"dist_{key}", np.asarray(val["dist"]).reshape(1, -1))
        if "H" in val and "W" in val:
            intri.write(f"H_{key}", val["H"], dt="int")
            intri.write(f"W_{key}", val["W"], dt="int")
        if "Rvec" not in val:
            val["Rvec"] = rodrigues_inv(val["R"])
        extri.write(f"R_{key}", val["Rvec"])
        extri.write(f"Rot_{key}", val["R"])
        extri.write(f"T_{key}", val["T"])
    intri.close()
    extri.close()


def camera_from_img(img):
    height, width = img.shape[:2]
    focal = 1.2 * min(height, width)
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    camera = {
        "K": K,
        "R": np.eye(3),
        "T": np.zeros((3, 1)),
        "dist": np.zeros((1, 5)),
    }
    camera["invK"] = np.linalg.inv(K)
    camera["P"] = K @ np.hstack((camera["R"], camera["T"]))
    return camera


def interp_cameras(cameras, keys, step=20, loop=True, allstep=-1, **kwargs):
    """Slerped rotations and centers between the selected cameras."""
    from scipy.spatial.transform import Rotation as R
    from scipy.spatial.transform import Slerp

    if allstep != -1:
        tall = np.linspace(0.0, 1.0, allstep + 1)[:-1].reshape(-1, 1, 1)
    elif loop:
        tall = np.linspace(0.0, 1.0, 1 + step * len(keys))[:-1].reshape(-1, 1, 1)
    else:
        tall = np.linspace(0.0, 1.0, 1 + step * (len(keys) - 1))[:-1].reshape(
            -1, 1, 1)
    cameras_new = {}
    for ik in range(len(keys)):
        if ik == len(keys) - 1 and not loop:
            break
        if loop:
            start = (ik * tall.shape[0]) // len(keys)
            end = int((ik + 1) * tall.shape[0]) // len(keys)
        else:
            start = (ik * tall.shape[0]) // (len(keys) - 1)
            end = int((ik + 1) * tall.shape[0]) // (len(keys) - 1)
        t = tall[start:end].copy()
        t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
        left = keys[ik]
        right = keys[0 if ik == len(keys) - 1 else ik + 1]
        cl, cr = cameras[left], cameras[right]
        center_l = (-cl["R"].T @ cl["T"])[None]
        center_r = (-cr["R"].T @ cr["T"])[None]
        norm_l, norm_r = np.linalg.norm(center_l), np.linalg.norm(center_r)
        ul, ur = center_l / norm_l, center_r / norm_r
        costheta = float((ul * ur).sum())
        sintheta = np.sqrt(max(1.0 - costheta**2, 1e-12))
        theta = np.arctan2(sintheta, costheta)
        centers = (np.sin(theta * (1 - t)) * ul + np.sin(theta * t) * ur) / sintheta
        centers = centers * (norm_l * (1 - t) + norm_r * t)
        slerp = Slerp([0, 1], R.from_matrix(np.stack([cl["R"], cr["R"]])))
        interp_rots = slerp(t.squeeze()).as_matrix()
        T = -np.einsum("bmn,bno->bmo", interp_rots, centers)
        K = cl["K"] * (1 - t) + cr["K"] * t
        for i in range(T.shape[0]):
            cameras_new[f"{left}-{right}-{i}"] = {
                "K": K[i],
                "dist": np.zeros((1, 5)),
                "R": interp_rots[i],
                "T": T[i],
            }
    return cameras_new


def get_center_and_diag(cam_centers):
    center = np.mean(cam_centers, axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=1)
    return center.flatten(), np.max(dist) * 1.1
