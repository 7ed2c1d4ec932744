"""Host image I/O: BGR uint8 arrays, as OpenCV gives them.

PNG goes through the port's own codec (zlib and struct): 8-bit gray, RGB and
RGBA and 16-bit gray, non-interlaced, every filter type on read; always this
codec, whatever is installed. JPEG is decoded and encoded by `cv2`, else
`PIL`, where one imports; with neither, reading a JPEG raises and writing
one writes a PNG of the same stem instead (said once per process), while
`encode_jpeg` (the viewer's bytes in memory) raises.
Every file is written under a temporary name in its directory and
renamed into place (`atomic_path`), so that a reader, another rank
filling the same cache say, never sees half a file under its final name.
`resize_area` is OpenCV's INTER_AREA for integer factors, in numpy.
`make_video` joins numbered frames into an mp4 (ffmpeg, else cv2, else
skipped). Nothing here touches a device.
"""
from __future__ import annotations

import contextlib
import glob
import io
import os
import shutil
import struct
import subprocess
import zlib

import numpy as np

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}
_warned_no_jpeg = []


# ------------------------------------------------------------------ PNG
def _paeth_row(recon: bytearray, filt: bytes, prior: bytes, bpp: int):
    for x in range(len(filt)):
        a = recon[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        recon[x] = (filt[x] + pred) & 0xFF


def _average_row(recon: bytearray, filt: bytes, prior: bytes, bpp: int):
    for x in range(len(filt)):
        a = recon[x - bpp] if x >= bpp else 0
        recon[x] = (filt[x] + ((a + prior[x]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        filt = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            row = filt.copy()
        elif ftype == 1:  # Sub: a running sum per byte of the pixel
            row = (np.cumsum(filt.reshape(-1, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            row = filt + prior
        elif ftype in (3, 4):
            rec = bytearray(stride)
            fn = _average_row if ftype == 3 else _paeth_row
            fn(rec, filt.tobytes(), prior.tobytes(), bpp)
            row = np.frombuffer(bytes(rec), np.uint8)
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = row
        prior = out[y]
    return out


def png_decode(data: bytes) -> np.ndarray:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or uint16."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"PNG: unsupported color type {ctype}, depth "
                         f"{depth}, interlace {interlace}")
    if depth == 16 and ctype != 0:
        raise ValueError("PNG: 16-bit images must be gray")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    img = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, ch)
    return img[:, :, 0] if ch == 1 else img


def png_encode(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W) gray (uint8 or uint16), (H, W, 3) RGB or
    (H, W, 4) RGBA uint8. Each row takes the filter (None, Sub or Up)
    with the least sum of absolute signed residuals."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, ch = 16, 0, 1
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8:
        ch = 1 if img.ndim == 2 else img.shape[2]
        ctype = {1: 0, 3: 2, 4: 6}[ch]
        depth = 8
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"PNG: cannot encode {img.dtype} {img.shape}")
    height, stride = rows.shape
    bpp = ch * depth // 8
    prior = np.vstack([np.zeros((1, stride), np.uint8), rows[:-1]])
    left = np.hstack([np.zeros((height, bpp), np.uint8), rows[:, :-bpp]])
    cands = np.stack([rows, rows - left, rows - prior])  # uint8 wraps
    cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(axis=2)
    ftype = np.argmin(cost, axis=0)
    chosen = cands[ftype, np.arange(height)]
    raw = np.hstack([ftype.astype(np.uint8)[:, None], chosen]).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    width = img.shape[1]
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# ----------------------------------------------------------------- JPEG
def _jpeg_backend():
    """'cv2', 'PIL' or None: the first that imports."""
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import PIL.Image  # noqa: F401

        return "PIL"
    except ImportError:
        return None


def encode_jpeg(bgr: np.ndarray, quality: int = 85) -> bytes:
    """The JPEG bytes of a BGR uint8 image, through cv2, else PIL; raises
    where neither imports (a caller that serves images must not answer
    without one)."""
    backend = _jpeg_backend()
    if backend == "cv2":
        import cv2

        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY,
                                             int(quality)])
        if not ok:
            raise OSError("cv2 could not encode the JPEG")
        return buf.tobytes()
    if backend == "PIL":
        from PIL import Image

        out = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(
            out, format="JPEG", quality=int(quality))
        return out.getvalue()
    raise RuntimeError("no JPEG encoder: neither cv2 nor PIL imports")


def _is_png(name: str) -> bool:
    return os.path.splitext(name)[1].lower() == ".png"


def imread(name: str, flags: int = IMREAD_COLOR):
    """The image at `name` as cv2.imread gives it (BGR / BGRA uint8, gray
    2-D, uint16 gray), or None where the file is missing. flags:
    IMREAD_COLOR (3 channels, 8 bits) or IMREAD_UNCHANGED (as stored)."""
    if not os.path.exists(name):
        return None
    if _is_png(name):
        with open(name, "rb") as f:
            img = png_decode(f.read())
        if img.ndim == 3:
            img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]  # RGB(A) -> BGR(A)
    else:
        backend = _jpeg_backend()
        if backend == "cv2":
            import cv2

            return cv2.imread(name, flags)
        if backend is None:
            raise RuntimeError(f"cannot read {name}: no JPEG decoder (neither "
                               f"cv2 nor PIL imports)")
        from PIL import Image

        with Image.open(name) as im:
            img = np.asarray(im.convert("RGB"))[:, :, ::-1].copy()
    if flags == IMREAD_UNCHANGED:
        return img
    if img.dtype != np.uint8:
        raise ValueError(f"{name}: IMREAD_COLOR of {img.dtype} is not "
                         f"supported; read it with IMREAD_UNCHANGED")
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


@contextlib.contextmanager
def atomic_path(name: str):
    """A temporary path beside `name` (same directory and extension, which
    the encoders read) that becomes `name` by one os.replace when the block
    ends; where the block raises, the temporary file is removed and `name`
    is left as it was."""
    folder, base = os.path.split(name)
    stem, ext = os.path.splitext(base)
    tmp = os.path.join(folder, f".{stem}.{os.getpid()}.tmp{ext}")
    try:
        yield tmp
        os.replace(tmp, name)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_bytes_atomic(name: str, data: bytes) -> None:
    """`data` as the file `name`, written through atomic_path."""
    with atomic_path(name) as tmp:
        _write_bytes(tmp, data)


def imwrite(name: str, img) -> str:
    """Write a BGR(A) / gray image as cv2.imwrite does, through atomic_path;
    returns the path written (a .png in place of a JPEG where no encoder
    imports)."""
    os.makedirs(os.path.dirname(name) or ".", exist_ok=True)
    img = np.asarray(img)
    if not _is_png(name):
        backend = _jpeg_backend()
        if backend == "cv2":
            import cv2

            with atomic_path(name) as tmp:
                if not cv2.imwrite(tmp, img):
                    raise OSError(f"cv2 could not write {name}")
            return name
        if backend == "PIL":
            from PIL import Image

            rgb = img if img.ndim == 2 else img[:, :, 2::-1]
            with atomic_path(name) as tmp:
                Image.fromarray(np.ascontiguousarray(rgb)).save(tmp,
                                                                quality=95)
            return name
        if not _warned_no_jpeg:
            _warned_no_jpeg.append(True)
            print(f"[image_io] no JPEG encoder (neither cv2 nor PIL imports): "
                  f"writing .png files in place of {os.path.splitext(name)[1]}")
        name = os.path.splitext(name)[0] + ".png"
    if img.ndim == 3:
        img = img[:, :, [2, 1, 0, 3][:img.shape[2]]]  # BGR(A) -> RGB(A)
    write_bytes_atomic(name, png_encode(img))
    return name


# --------------------------------------------------------------- resize
def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_AREA).

    Integer factors (the same on both axes, dividing both sizes) are the
    box mean in numpy: uint8 by 2 rounds (sum + 2) >> 2 as OpenCV's vector
    path does, other integer factors round the mean half to even (cvRound);
    float images take the mean. Other sizes go through cv2, or raise."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    if (width, height) == (W, H):
        return img.copy()
    f = W // width if width else 0
    if f >= 1 and W == f * width and H == f * height:
        blocks = img.reshape(height, f, width, f, *img.shape[2:])
        if img.dtype == np.uint8:
            s = blocks.astype(np.int64).sum(axis=(1, 3))
            if f == 2:
                return ((s + 2) >> 2).astype(np.uint8)
            return np.clip(np.rint(s / float(f * f)), 0, 255).astype(np.uint8)
        s = blocks.sum(axis=(1, 3), dtype=np.float64)
        return (s * (1.0 / (f * f))).astype(img.dtype)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"resize_area from {W}x{H} to {width}x{height} is "
                           f"not an integer factor and cv2 is not available")
    return cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)


# ---------------------------------------------------------------- video
def make_video(path, fps=30):
    """<path>.mp4 from the numbered frames in `path` (.jpg, or .png where
    the frames were written as PNG): through ffmpeg where it is on PATH,
    else OpenCV's writer where cv2 imports, else skipped with a message."""
    frames = sorted(glob.glob(os.path.join(path, "*.jpg"))) or \
        sorted(glob.glob(os.path.join(path, "*.png")))
    if not frames:
        return
    ext = os.path.splitext(frames[0])[1]
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-r", str(fps), "-i", f"{path}/%06d{ext}",
               "-vf", "scale=2*ceil(iw/2):2*ceil(ih/2)", "-vcodec", "libx264",
               "-r", str(fps), f"{path}.mp4", "-loglevel", "quiet"]
        print(" ".join(cmd))
        if subprocess.run(cmd).returncode == 0 and os.path.exists(path + ".mp4"):
            return
    try:
        import cv2
    except ImportError:
        print(f"[make_video] neither ffmpeg nor cv2: {path}.mp4 skipped "
              f"({len(frames)} frames in {path})")
        return
    first = imread(frames[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(path + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    if not vw.isOpened():
        print(f"[make_video] cv2 writer failed for {path}.mp4")
        return
    for f in frames:
        vw.write(imread(f))
    vw.release()
    print(f"[make_video] wrote {path}.mp4 via cv2 ({len(frames)} frames)")
