"""The port's viewer (log_tpu_torch/apps/viewer.py) against the JAX
package's apps/viewer.py, on the CPU.

ViewerState.camera equals the JAX one to 1e-12 for five poses; the BGR frame
that render_jpeg encodes is within one 8-bit unit of the JAX frame (the
same steps: camera, clear, prepare_from_camera, render_one, tensor_to_bgr)
on at most 0.1% of the pixels, on a BaseGaussian and on a small LoD tree
(both oracles); GET /, /render and a 404 go through make_handler (served
on 127.0.0.1:0, or on a fake request where sockets are refused);
make_state builds the viewer of config/synthetic_conv/train.yml from a
small checkpoint; check_viewer --oneshot writes its JPEG.
"""
import io
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from apps.viewer import ViewerState as ViewerStateJax
from log_tpu.dataset.synthetic import random_gaussians as random_gaussians_jax
from log_tpu.model.base_gaussian import BaseGaussian as BaseGaussianJax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.render.renderer import NaiveRendererAndLoss as RendererJax
from log_tpu_torch.apps import check_viewer, viewer
from log_tpu_torch.dataset.synthetic import random_gaussians
from log_tpu_torch.model.base_gaussian import BaseGaussian
from log_tpu_torch.model.level_of_gaussian import LoG
from log_tpu_torch.render.renderer import NaiveRendererAndLoss
from log_tpu_torch.utils import image_io
from log_tpu_torch.utils.config import Config
from log_tpu_torch.utils.synth_tree import build_checkpoint

POSES = ((0.0, 0.5, 4.0, (0.0, 0.0, 0.0)), (0.3, 0.4, 4.0, (0.1, -0.2, 0.0)),
         (2.1, -0.7, 2.5, (0.0, 0.0, 0.3)), (-1.3, 1.4, 6.0, (1.0, 0.5, -0.5)),
         (3.0, 1.5, 3.0, (-0.4, 0.0, 0.2)))
H, W = 48, 64
TREE_KEYS = ["xyz", "colors", "scaling", "opacity", "rotation", "shs"]
TREE_ARGS = {
    "use_view_correction": True,
    "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
    "optimizer": {"optimize_keys": TREE_KEYS, "opt_all_levels": True,
                  "lr_dict": {"xyz": 0.00016, "colors": 0.0025,
                              "max_steps": 600}},
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {},
}


def _states(kind):
    """(JAX ViewerState, port ViewerState) over the same model: 2,000
    random Gaussians (BaseGaussian, SH 0) or a 600-root synthetic tree
    (LoG, SH 1) seen from above."""
    if kind == "base":
        mj = BaseGaussianJax.create_from_record(
            random_gaussians_jax(2000, np.random.default_rng(0)), sh_degree=0)
        mt = BaseGaussian.create_from_record(
            random_gaussians(2000, np.random.default_rng(0)), sh_degree=0,
            device="cpu")
        center, focal = (0.0, 0.0, 0.0), 60.0
    else:
        ckpt = build_checkpoint(600, seed=4)
        mj, mt = LoGJax(**TREE_ARGS), LoG(**TREE_ARGS, device="cpu")
        for m in (mj, mt):
            m.load_state_dict(ckpt)
        center, focal = (0.0, 0.0, 1.0), 40.0
    for m in (mj, mt):
        m.eval()
        m.set_state(enable_sh=True)
    sj = ViewerStateJax(mj, RendererJax(split="demo"), H, W, focal, center,
                        0.01, 100.0)
    st = viewer.ViewerState(mt, NaiveRendererAndLoss(split="demo",
                                                     device="cpu"),
                            H, W, focal, center, 0.01, 100.0)
    return sj, st


def _bgr_jax(state, yaw, pitch, dist, offset):
    """The BGR frame apps/viewer.py's render_jpeg encodes."""
    camera = state.camera(yaw, pitch, dist, offset)
    state.model.clear()
    state.model.prepare_from_camera(camera)
    out = state.renderer.render_one(state.model, camera,
                                    np.ones(3, np.float32))
    return state.renderer.tensor_to_bgr(out["render"])


def test_camera_matches_jax():
    sj, st = _states("base")
    for yaw, pitch, dist, offset in POSES:
        want = sj.camera(yaw, pitch, dist, np.asarray(offset))
        got = st.camera(yaw, pitch, dist, np.asarray(offset))
        assert sorted(got) == sorted(want)
        for key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("kind,pose", [
    ("base", (2.0, -0.3, 3.0, (0.2, 0.0, 0.0))),
    ("tree", (2.5, 0.6, 10.0, (3.0, -2.0, 0.0))),
])
def test_frame_matches_jax(kind, pose):
    sj, st = _states(kind)
    for yaw, pitch, dist, offset in (pose,):
        want = _bgr_jax(sj, yaw, pitch, dist, np.asarray(offset))
        got = st.render_bgr(yaw, pitch, dist, np.asarray(offset))
        assert got.shape == (H, W, 3) and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).any(axis=2).mean() <= 1e-3
        assert got.std() > 10  # not a blank frame
        # the JPEG the handler answers decodes to that frame
        jpeg = st.render_jpeg(yaw, pitch, dist, np.asarray(offset))
        back = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        assert back.shape == got.shape
        assert np.abs(back.astype(float) - got).mean() < 8.0


def test_encode_jpeg_backends(monkeypatch):
    rng = np.random.default_rng(1)
    bgr = np.repeat(np.linspace(0, 255, 64, dtype=np.uint8)[None], 48, 0)
    bgr = np.dstack([bgr, bgr[::-1], np.full_like(bgr, 90)])
    bgr[:4] = rng.integers(0, 256, (4, 64, 3))
    for backend in ("cv2", "PIL"):
        monkeypatch.setattr(image_io, "_jpeg_backend", lambda b=backend: b)
        jpeg = image_io.encode_jpeg(bgr, 85)
        assert jpeg[:2] == b"\xff\xd8"
        back = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        assert np.abs(back[8:].astype(float) - bgr[8:]).mean() < 3.0
    monkeypatch.setattr(image_io, "_jpeg_backend", lambda: None)
    with pytest.raises(RuntimeError, match="no JPEG encoder"):
        image_io.encode_jpeg(bgr, 85)


class _FakeRequest:
    """A handler call without a socket: the response bytes in wfile."""

    def __init__(self, handler_cls, path):
        h = handler_cls.__new__(handler_cls)
        h.path, h.command, h.requestline = path, "GET", f"GET {path} HTTP/1.1"
        h.request_version, h.client_address = "HTTP/1.1", ("127.0.0.1", 0)
        h.wfile = io.BytesIO()
        h.do_GET()
        head, _, self.body = h.wfile.getvalue().partition(b"\r\n\r\n")
        lines = head.decode().split("\r\n")
        self.status = int(lines[0].split()[1])
        self.headers = dict(line.split(": ", 1) for line in lines[1:])


def _get_all(handler_cls, paths):
    """{path: (status, content type, body)} through a server on
    127.0.0.1:0, or fake requests where the host refuses sockets."""
    try:
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    except OSError:
        out = {}
        for p in paths:
            r = _FakeRequest(handler_cls, p)
            out[p] = (r.status, r.headers.get("Content-Type"), r.body)
        return out
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # no proxy for localhost, whatever the environment says
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    out = {}
    try:
        for p in paths:
            url = f"http://127.0.0.1:{server.server_address[1]}{p}"
            try:
                with opener.open(url, timeout=120) as resp:
                    out[p] = (resp.status, resp.headers["Content-Type"],
                              resp.read())
            except urllib.error.HTTPError as err:
                out[p] = (err.code, None, b"")
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return out


def test_handler_routes():
    _, st = _states("base")
    q = "/render?yaw=0.3&pitch=0.4&dist=4&cx=0&cy=0&cz=0&_=0.5"
    got = _get_all(viewer.make_handler(st), ["/", q, "/nothing"])
    status, ctype, body = got["/"]
    assert status == 200 and ctype == "text/html"
    assert f'width="{W}" height="{H}"'.encode() in body
    status, ctype, body = got[q]
    assert status == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
    back = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    want = st.render_bgr(0.3, 0.4, 4.0, np.zeros(3))
    assert np.abs(back.astype(float) - want).mean() < 8.0
    assert got["/nothing"][0] == 404
    # the fake request path gives the same answers
    fake = _FakeRequest(viewer.make_handler(st), "/")
    assert fake.status == 200 and fake.body == got["/"][2]


def test_make_state_from_config(tmp_path):
    ckpt = build_checkpoint(300, seed=2)
    torch.save(ckpt, tmp_path / "model.pth")
    n = 200
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "sparse.npz", xyz=rng.uniform(-1, 1, (n, 3)),
             rgb=rng.integers(0, 256, (n, 3)))
    args, cfg = Config.load_args([
        "--cfg", "config/synthetic_conv/train.yml", "--device", "cpu",
        "ckptname", str(tmp_path / "model.pth"),
        "PLYNAME", str(tmp_path / "sparse.npz"), "root", str(tmp_path),
        "viewer.H", str(H), "viewer.W", str(W)])
    from log_tpu_torch.apps.train import resolve_device
    from log_tpu_torch.utils.command import update_global_variable

    cfg = update_global_variable(cfg, cfg)
    assert args.device == "cpu"
    state = viewer.make_state(cfg, resolve_device(args.device))
    model = state.model
    assert isinstance(model, LoG) and not model.training
    assert model.num_points == ckpt["gaussian.xyz"].shape[0]
    assert model.gaussian.active_sh_degree == 1
    assert (state.H, state.W, state.focal) == (H, W, 1.2 * W)
    np.testing.assert_allclose(state.center,
                               ckpt["gaussian.xyz"].mean(axis=0), rtol=1e-6)
    assert state.renderer.split == "demo"
    bgr = state.render_bgr(0.5, 0.9, 16.0, np.zeros(3))
    assert bgr.shape == (H, W, 3) and bgr.std() > 5


def test_check_viewer_oneshot(tmp_path):
    out = tmp_path / "check.jpg"
    jpeg = check_viewer.main(["--oneshot", "--device", "cpu", "--out",
                              str(out)])
    assert out.read_bytes() == jpeg and jpeg[:2] == b"\xff\xd8"
    img = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
    assert img.shape == (check_viewer.H, check_viewer.W, 3) and img.std() > 20


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_viewer.main(["--oneshot"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.main(["--cfg", "config/synthetic_conv/train.yml"])
